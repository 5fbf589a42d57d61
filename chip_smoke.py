"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port (all thirteen wrappers': the TIMIT,
CIFAR, MNIST, VOC, sparse and sketched paths, the block update's
``sym=False`` route and the linear models' row-stable product) from the ten
sources of ``keystone_tpu_torch/csrc/`` (one ``nvcc`` per source, all
started together), then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the TIMIT, CIFAR and sparse slices give it, with float32 and
     (except the convolution) bfloat16 operands, and times the kernel, the
     plain version and a PyTorch library yardstick that computes the same
     function; ``gram_corr_sym_acc`` on the Amazon chunk (65,536 x 16,385,
     k = 2; bf16 F at the fold's 64-element row stride, on the tensor
     cores, with the count of HGMMA instructions in its SASS checked at
     build time; f32 F at the fold's 4-element row stride and at 16,385,
     the same bits, beside two float32 ``addmm``) and on the ragged last
     chunk of 41,248 rows, in place and into a new buffer; ``gram_corr``
     at the Gramian shape beside ``gram_corr_sym`` (one kernel of
     ``csrc/gram_corr.cu``, both outputs the same bits); ``gram_corr_sym``
     also at the VOC fit's shape (5,011 x 4,096, k = 20: one ragged row
     chunk);
     bf16 ``block_gram_sym`` and ``gram_sym_acc`` on the tensor cores
     (``csrc/gram_wgmma.cuh``, row 8's mainloop): their grids (the window's
     528 upper tiles, the streamed tile's 8,256, one block an SM, F read in
     place), their bit links (``block_gram_sym`` = ``gram_sym_acc`` on G =
     0 mirrored; ``gram_sym_acc`` = ``gram_corr_sym_acc``'s Gramian), each
     bf16 time beside its bf16 bound and bf16 ``addmm``, bf16
     ``gram_sym_acc`` at 65,536 x 16,384 against float64 sums (2e-5 of
     their scale), and bf16 ``gram_corr_sym_acc``'s SHA-256 on a fixed
     Amazon chunk against its build before the mainloop moved
     (``row8_bits``);
     for the kernels on the pipelined tile of ``csrc/fma_pipe.cuh``
     (``block_corr``, ``gram_corr``, ``block_gram_sym`` and
     ``gram_sym_acc`` with f32 F (the window's 528 upper tiles, the
     streamed tile's 8,256), ``gram_corr_sym_acc`` with f32 F,
     ``block_residual_update``,
     ``gaussian_kernel_block``, ``gaussian_resid_block``,
     ``cosine_features``, ``conv_featurize``) also each grid: label (filter)
     tile and masked share, blocks (and ``block_corr``'s row chunks,
     ``gaussian_kernel_block``'s feature chunks, ``conv_featurize``'s
     pixel tiles on its persistent grid), resident blocks an SM, waves,
     registers and spills; ``conv_featurize`` on one row chunk of CIFAR
     images, also timed on the device alone and beside the product alone
     on cuBLAS (``torch.matmul`` of the normalised patch matrix, made
     before timing, by the filters);
     ``gaussian_kernel_block`` at each shape of the CIFAR route (train
     apply, test apply, diagonal block, ragged last diagonal block), each
     with its bound and its ``exp(addmm)`` yardstick;
     ``countsketch_scatter``
     at the reference's small check geometry and at the sketched tier's
     Amazon chunk (65,536 rows of 83 slots into 32,770 x 16,385), in place
     and fresh, against its plain version run on the CPU (bit for bit),
     timed whole and as its index preparation and scatter kernel apart;
  2. checks that a small run of the three TIMIT routes on the card agrees
     with the plain-PyTorch run of it on the CPU, then drives the
     ``--solver block`` slice end to end through its entry point,
     ``keystone_tpu_torch.pipelines.timit.run``, at the full width of the
     reference's bench headline (440 inputs, 4 x 4096 cosine features,
     147 classes, 65,536 training rows, 3 epochs) by both routes, each with
     every kernel's launch count set to 0 just before and read just after:
       - the stacked route (``fit_first=False``: apply before fit, as the
         reference's ``run`` does), through ``cosine_features`` and
         ``gram_corr_sym``;
       - the fused flat route (``pipeline.fit()`` first), through
         ``cosine_features``, ``block_gram_sym``, ``block_corr`` and
         ``block_residual_update``;
  3. fits and applies the README quick-start composition (one 440 -> 4096
     cosine featurizer, block least squares with block 1024, 3 iterations,
     λ 1e-4, then MaxClassifier) on the same rows, through the fused fit;
  4. drives ``--solver streaming`` at the same width on 275,000 training
     rows (8 full row tiles of 32,768 and a ragged one), launches counted
     from 0: the tile fold through ``gram_sym_acc`` and the tile-wise
     featurizer through ``cosine_features``;
  5. fits and applies the optimizer-bound streamed fit (the TIMIT
     featurizer composed with ``StreamingLeastSquaresChoice``, which
     ``StreamedFitFusionRule`` binds into the fit) on 65,536 rows, and
     holds its errors against ``--solver streaming`` on the same rows;
  6. runs RandomPatchCifarKernel small on the card against its plain run on
     the CPU (equal errors), then through its entry point
     ``keystone_tpu_torch.pipelines.cifar.run_random_patch_cifar_kernel``
     at full width: 50,000 synthetic training and 12,500 test images, 100
     whitened 6 x 6 x 3 filters, rectifier and pool to 1,800 features,
     Gaussian kernel ridge regression with block 512 (98 blocks, the last
     one 336 rows), 1 epoch; launches counted from 0 and checked against
     their expected counts: ``conv_featurize`` once per row chunk of each
     featurization, ``gaussian_kernel_block`` once per block in the
     diagonal pre-pass and in each apply, ``gaussian_resid_block`` once
     per sweep step, every TIMIT kernel 0;
  7. measures where that fit's time goes: its Gauss-Seidel sweep with and
     without the per-step host sync of the solve's rescue decision, and a
     warm fit and apply under ``torch.profiler`` in a fresh process
     (``python3 chip_smoke.py --cifar-profile``: device time by name, the
     device's busy share), whose traced launches of each port kernel must
     equal the launches the route counted, times the kernels a call
     launches (the profiler lost records of the port's kernels late in
     this long process, so a short profile fails the phase);
  8. runs the sparse ridge slice (``SparseLBFGSwithL2``): small on the card
     against its plain run on the CPU (the same weights and final loss),
     then at the Amazon geometry of the reference's bench row (n = 500,000
     rows of d = 16,384 features with 82 active a row, k = 2, λ 1e-3, 20
     L-BFGS iterations; labels from a planted sparse model), fitted through
     a ``Sparsify`` pipeline and applied to the training and 125,000 test
     rows by four engines — gather, gram with bf16 slabs, gram with f32
     slabs, gram over the compressed-resident int16 + bf16 COO — each with
     the launch counts set to 0 before and read after: every gram fit
     launches ``gram_corr_sym_acc`` once per chunk (8) and nothing else,
     the gather fit no kernel; the compressed engine gives the bits of the
     bf16 one. Last, ``run_lbfgs_gram_streamed`` over 524,288 resident
     rows (8 chunks) whole and in segments of 3 chunks: the same bits.
  9. runs the sketched tier: small on the card against its plain run on the
     CPU (sparse, compressed and SRHT fits; SRHT, IHS and the sketch-and-
     solve estimator on a dense problem), then on phase 8's Amazon rows the
     reference's frontier sweep (bench.py:1401-1415, seed 7) through a
     ``Sparsify`` pipeline: ``IterativeHessianSketch`` raw and compressed
     at m = 32,770 (pinned: the guard rolls back after 2 passes) and 65,540
     (pinned: 3 passes, 3 steps kept; compressed within the bf16 tolerance
     of raw), ``SketchedLeastSquares`` at 32,770 with 12 PCG iterations;
     launches counted from 0 for each fit (``countsketch_scatter`` 8 a
     fold pass for IHS, nothing for SRHT), and where one IHS fit's time
     goes (fold, gradient operand, SAᵀSA, Cholesky), timed with CUDA
     events;
 10. runs one stacked block update at TIMIT width (A 65,536 x 4,096, R
     65,536 x 147) with ``sym=False`` (one ``gram_corr`` launch, counted
     from 0) and with ``sym=True``: the same weights and residual.
 11. drives TIMIT ``--solver auto`` (the default: the cost-model selector,
     ``cost.LeastSquaresEstimator``) at the same width, λ 0, through
     ``timit.run`` on the card's own memory budget, launches counted from
     0, logging the selector's budget and each candidate's cost, resident
     GiB and feasibility, and timing the selector (sampling and pricing),
     the fit and the applies:
       - (a) resident, 65,536 rows: the winner must be the ``Densify`` ->
         ``BlockLeastSquaresEstimator`` chain, its weights those of phase
         2's ``--solver block`` apply-first route on the same rows (1e-5
         relative), through ``cosine_features`` and ``gram_corr_sym``;
       - (b) past the memory wall, 1,310,720 rows (40 tiles of 32,768):
         every resident candidate must be over the budget by more than 5%,
         the winner the streaming choice, which the optimizer binds to the
         cosine bank, with ``gram_sym_acc`` launched once a tile (40), and
         its model (``W_stack``, ``fmean``, ``ymean``) that of
         ``--solver streaming`` on the same rows and draws (1e-5 relative);
       - (c) the bf16 Gramians' routes, launches counted from 0: the
         streamed fit over a bf16 cosine bank on (b)'s rows (20 tiles of
         65,536: 20 ``gram_sym_acc``), its model within 5e-3 of
         ``--solver streaming``'s float32 one, and the flat fused fit on a
         bf16 65,536 x 16,384 slab (4 ``block_gram_sym``), within 5e-3 of
         the float32 slab's; no operand staged on either.
 12. drives TIMIT ``--solver auto`` at the reference's default width (50
     cosine branches: d = 204,800), past both walls, where the selector
     takes the block-streamed tier (``BlockStreamedLeastSquares`` on
     ``streaming_block_bcd_mesh``, one device):
       - (a) the block program and the estimator small on the card against
         their plain runs on the CPU: float32 and bf16 features, centred
         and raw, ragged rows (weights within 1e-4, bf16 5e-3);
       - (b) ``BlockStreamedLeastSquares`` on phase 2's rows and draws
         (65,536 rows, d = 16,384, block 4,096, 3 epochs, λ 0) held
         against phase 2's ``--solver block`` apply-first model (weights
         and affine offset within 1e-4 relative: the same centred BCD
         iterates, centred by a rank-1 correction instead of explicitly);
         then the bf16 bank on the same rows, its weights' gap and errors
         logged beside float32's;
       - (c) ``timit.run(TimitConfig(solver="auto", num_cosines=50, ...,
         synthetic_n=131072))`` (n cut from 2.2e6 to stay inside the
         script's time limit): the winner the streaming choice, one
         streamed model fitted by ``BlockStreamedLeastSquares`` at block
         4,096, every resident candidate over the budget by more than 5%,
         launches counted from 0 and exact (``cosine_features`` 265,
         ``gram_corr_sym`` 50, ``block_corr`` 100,
         ``block_residual_update`` 150, every other kernel 0), the peak
         under the budget, logged beside the priced resident bytes;
       - (d) ``cosine_features``, ``gram_corr_sym``, ``block_corr`` and
         ``block_residual_update`` on one float32 block slab of 589,824 x
         4,096 = 2.42e9 elements (past 2^31, the north-star n's slab): the
         row-local outputs of the last 4,096 rows and the reductions over
         the whole slab against their plain versions; before that, and on
         a slab of the north star's 2,200,000 rows (36 GB), the cosine
         Gramian and correlation of ``gram_corr_sym`` against float64 sums
         made on the card, each at most 1.25 times as far from them as
         cuBLAS's float32 ones in the same run.
 13. runs MnistRandomFFT: small on the card against its plain run on the
     CPU, then through ``keystone_tpu_torch.pipelines.mnist_random_fft.run``
     at its own width (784 inputs, 4 random-sign padded FFTs of 1,024, 2,048
     features, block 2,048, 1 epoch, λ 0; 60,000 training and 10,000 test
     rows of ``synthetic_mnist``), apply first (the reference's order: one
     ``gram_corr_sym`` launch at A 60,000 x 2,048, k = 10) and fit first
     (one launch each of ``block_gram_sym``, ``block_corr`` and
     ``block_residual_update``), launches counted from 0, the gather's
     packed FFT checked, the weights held against the same route with its
     kernels swapped for their plain versions on the card, errors, fit and
     apply seconds and peak memory logged; then ``gram_corr_sym`` alone at
     that shape against its plain version, library call and bound.
 14. runs AmazonReviewsPipeline: its L-BFGS on the card against the CPU on
     2,000 documents (the loss after every step within 1e-5 relative), then
     through ``keystone_tpu_torch.pipelines.amazon_reviews.run`` on 200,000
     training and 50,000 test ``synthetic_documents`` (2-grams, 1,000
     common features, 20 iterations), host seconds by stage apart from the
     L-BFGS's device seconds, its steps, final loss and accuracy; no kernel
     is launched.
 15. runs the image featurizer's modules small on the card against the
     CPU (SIFT, LCS, the GMM fit, Fisher vectors, BWLS), then
     VOCSIFTFisher through ``keystone_tpu_torch.pipelines.voc_sift_fisher.run``
     at KeystoneML's VOC width (descDim 80, vocab 256: d = 40,960, block
     4,096, lambda 0.5, one epoch) on VOC 2007's 5,011 training and 4,952
     test images (synthetic, 64 x 64), launches counted from 0: exactly ten
     ``gram_corr_sym`` launches and no other kernel; host seconds by stage
     (SIFT, column PCA, k-means++, EM, Fisher vectors, solve), fit, apply,
     peak memory, MAP; the fit's weights against the same fit with
     ``gram_corr_sym`` swapped for its plain version (1e-4 relative) and
     against the same fit in float64 (at most 1.25 times as far from it as
     the plain version's).
 16. runs ImageNetSiftLcsFV through
     ``keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv.run`` at the
     reference config's widths (d = 4,096) and 1,000 classes on 16,000
     training and 5,000 test images of 64 x 64: no kernel launched; host
     seconds by stage, fit, apply, peak memory, top-1 and top-5 errors.
 17. runs the CLI's last six pipelines and Nyström KRR at full width:
       - (a) in phase 1: ``conv_featurize`` without a whitener (RandomCifar's
         Gaussian filters) on a 32 x 32 row chunk and with one on a chunk
         of 24 x 24 crops, and ``gaussian_kernel_block`` at Nyström's
         K(X, L) (50,000 x 2,048) and K(L, L) (2,048 x 2,048, its clamp
         checked), each against its plain version and timed;
       - (b) LinearPixels, RandomCifar, RandomPatchCifar and
         RandomPatchCifarAugmented through ``cifar.RUNNERS`` at phase 6's
         geometry (blocks of 512, lambda 10; the augmented runner on 8
         training crops of 24 x 24 an image and the 5 centre and corner
         crops of each test image, voted), apply first, launches counted
         from 0: ``conv_featurize`` once a row chunk of the fused
         featurizer's byte budget, ``gram_corr_sym`` 0 (the block fits are
         stepwise at 1,800 and 800 features), every other kernel 0;
       - (c) ``NystromKernelRidge`` (gamma 5e-4, lambda 10, 2,048
         landmarks) on RandomPatchCifar's standardised training features,
         k-means++ and uniform landmarks: ``gaussian_kernel_block`` 2 a fit
         and 1 an apply, by shape; alpha within 1e-3 of a float64 solve of
         the same normal equations made on the card from the same K_nm;
       - (d) NewsgroupsPipeline on 11,314 + 7,532 synthetic documents, 20
         classes, bigrams: n, d, the dense bytes, seconds and errors;
       - (e) StupidBackoffPipeline on 100,000 synthetic sentences, n = 3:
         every score in (0, 1], the vectorised scorer equal to the dict
         loop on 10,000 sampled n-grams.

 18. drives the workflow layer on the card:
       - (a) the plan verifier on the north star's fit graph (TIMIT
         ``--solver auto``, 50 cosine branches: d = 204,800) with 2,200,000
         real source rows on the card, in strict mode: no finding, every
         launch counter unchanged, 0 bytes allocated (the peak equal to what
         was allocated at the start), its milliseconds; then the dry run's
         five pipelines (``keystone_tpu_torch.tools.dryrun``) on the card,
         clean; and in a fresh process (``python3 chip_smoke.py
         --first-verify``) the first and second verification of the dry
         run's TIMIT graph, beside the seconds of importing
         ``torch._dynamo``, which PyTorch's Python meta kernels import at
         their first call;
       - (b) bench.py's ``autocache_host_boundary`` sweep (65,536 rows of
         512 inputs, a host decode stage, 4,096 cosine features,
         ``BlockLeastSquaresEstimator(512, 1, λ)``, a cold 3-fit λ-sweep and
         3 warm ones, a 256-row probe apply after each fit) under
         ``DefaultOptimizer`` and ``AutoCachingOptimizer(GreedyCache(3
         GiB))``: walls, cache insertions, full-size decode calls and
         launches a fit; greedy must place a Cacher, decode the full rows
         fewer times, give each λ's weights bit for bit, and no profiled
         node may fall back to an empty profile;
       - (c) the plan of ``autocache_on_chip``'s fully fusable chain (512 ->
         8,192 cosine -> rectify -> 2,048 cosine, 131,072 rows): no Cacher
         inside the fused program under post-fusion greedy, the pre-fusion
         order's insertions beside it;
       - (d) phase 2's fitted TIMIT pipeline (fit first), its scores for
         1,000 single rows through the captured CUDA-graph program and for
         100 through the per-node walk (a host stage appended, so the
         composition refuses): each within 1e-6 relative of the batch
         apply's row, one capture for the one shape, ``cosine_features``
         counted 4 a datum, replays included; median and p99 microseconds
         a datum on each path.
 19. drives the online serving path on the card:
       - (a) phase 2's fitted TIMIT pipeline (fit first, its scores) exported
         at ``max_batch`` 256: every one of the 8 padding buckets captured
         into a CUDA graph at export, ``trace_count`` unchanged by serving;
         40 staggered requests through ``MicroBatchServer``: the served rows
         bit for bit against the plan's batch apply of the 40 rows, and
         within 1e-6 relative of the fitted pipeline's own apply (its nodes
         walked unfused); where the bits of 2 rows part from
         those of 40 and of 256, stage by stage (ROADMAP C.8);
         ``cosine_features`` counted 4 a replay times the batches served;
         each bucket program against the same composed function with
         ``cosine_features`` swapped for its plain version (1e-5
         relative); ``single_request_s``; export seconds;
       - (b) ``python -m keystone_tpu_torch.run serve`` at the
         MnistRandomFFT defaults (784 inputs, 4 FFTs, block 2,048, 4,096
         fit rows), rate 200, with one replica and then two, run in this
         process: the books of its summary line balance (offered = completed
         + rejected + failed, none failed), the plan composed, and the
         quick fit launched ``block_gram_sym``, ``block_corr`` and
         ``block_residual_update`` once each;
       - (c) a hot swap under Poisson load: two TIMIT plans (seeds 0 and
         1), two replicas sharing one plan, ``swap_plan`` midway: every
         response carries one of the two fingerprints, each within 1e-6
         relative of its plan's batch apply of the 256 request rows (the
         bit-identical ones counted), no request dropped; the swap's
         seconds;
       - (d) open-loop latency at 200 Hz, 2,000 Hz and 0.8 x the
         batch-size-1 closed-loop rate, each beside the same scores plan
         exported at ``max_batch`` 1: p50, p99 and throughput.
 20. drives continuous learning on the card:
       - (a) ``row_stable_matmul`` at 2, 256 and 65,536 rows x 16,384 x 147
         (TIMIT's scores product: the plan's smallest and largest buckets
         and a batch apply): inside the rounding bound of float64 sums,
         within twice it of its plain version, every row the bits of the
         65,536-row call; its time (and device time), the plain version's,
         cuBLAS's ``X @ W`` and the bound, and each grid;
       - (b) the TIMIT plan through the gate's bucket dry run (every bucket
         the same bits), 19(c)'s responses each bit-equal to its plan's
         256-row batch apply, the single-request time of 19(a);
       - (c) ``python -m keystone_tpu_torch.run learn`` at its defaults (16
         -> 4, 2 replicas, ``max_batch`` 64) and at 440 -> 147, run in this
         process: the books balance, 3 or more published, none rejected at
         the gate, staleness measured, all 24 segments fit;
       - (d) the gate at TIMIT width on 2 replicas under 400 Hz of Poisson
         load: a NaN-weight candidate rejected and serving nothing, the
         seed-1 TIMIT plan through the gate (held-out scores on 2,048 fresh
         rows), a 1 s canary and promotion, the books balanced;
       - (e) a trainer at 440 -> 147 killed at ``trainer.fit`` with a
         checkpoint directory resumes and publishes the fingerprint of an
         uninterrupted run;
       launches counted from 0 over (c)-(e): ``row_stable_matmul`` and
       ``cosine_features`` must both launch.
 21. drives the out-of-core data plane (disk shards, the prefetcher, the
     disk tier of the fits) on the card, each part's launches counted from
     0, the shards in a directory under ``build/`` removed at the end:
       - (a) TIMIT from disk at the north star's n: 2,200,000 x 440 rows
         (147 classes) written with ``DiskDenseShardWriter`` in tiles of
         8,192, 2 a segment; a ``Pipeline`` of 4 x 4,096 cosines ->
         ``LeastSquaresEstimator(host_budget_bytes=1 GiB)`` on the
         shard-backed data: the selector must pick the disk tier and the
         fit fold prefetched segments through ``cosine_features`` and
         ``gram_sym_acc`` (one launch a tile); fit seconds at prefetch depth
         2 and 0 (bit-equal weights), the overlap fraction, the peak
         allocated bytes against the priced ones (at most 1.2 x), and
         predictions on 65,536 held-out rows within 5e-4 of a resident
         streamed fit of the same rows on the card;
       - (b) the disk fold killed by an injected read fault after 100
         segments resumes from its checkpoint to (a)'s bits;
       - (c) the sparse disk tier at the Amazon geometry: the rows of phase
         8 written with ``DiskCOOShards`` and folded by
         ``run_lbfgs_gram_streamed(segment_source=)`` at depth 2 and 0 (bit
         equal, and the bits of phase 8's bf16 gram engine); a segmented
         fold under ``KEYSTONE_CHECKPOINT_DIR`` killed and resumed;
       - (d) ``csv_to_disk_shards`` on a 65,536-row TIMIT-width CSV the
         phase writes (rows within 1e-5, labels exact), and ``load_images``
         of 5,011 64 x 64 synthetic images under a budget that forces the
         spill, prefetched onto the card: the bytes of the resident decode.
 22. drives the model zoo and the autoscaler on the card, with TIMIT plans
     (pickle clones of phase 19's seed-0 and seed-1 fits, 440 -> 4 x 4,096
     cosines -> 147):
       - (a) 6 tenants (seeds 0 and 1 in turn, max_batch 256) under a budget
         of 3 tenants' charge, 40 staggered requests a tenant in turn, two
         rounds: every response bit-equal to its tenant's plan applied
         offline to the 40 rows, every fingerprint held across page round
         trips, the launches (counted from 0 over the rounds) those of the
         replays and of the page-ins' rebuilt buckets, allocated memory flat
         across rounds, each page-out freeing at least the tenant's charge;
         page-in and page-out walls, the compression, allocated / charged
         bytes of a resident tenant, and the stall 3 page-ins put on a
         resident tenant's closed loop;
       - (b) the reference's isolation drill: 8 tenants at max_batch 8, one
         hot at 80 x a 25 Hz base, availability objective 0.95: only the hot
         tenant leaves OK, the others 0 rejected and 0 failed, the books
         balanced;
       - (c) a deadline of half the page-in estimate fast-fails with
         ``TenantColdStart``;
       - (d) ``run.py serve --tenants 4 --zoo-budget-mb`` (2.5 tenants'
         charge) and ``serve --autoscale`` at MnistRandomFFT's defaults:
         exit 0, books balanced, pages where the budget binds, the quick
         fit's launches;
       - (e) a ``ReplicatedServer`` of the seed-0 plan at batch size 1 under
         an ``Autoscaler`` (1 to 3 replicas, a latency SLO at 20 x the
         single-request time): each replica count's capacity, then a load
         step at 1.5 x one replica's capacity and legs at 0.1 x until the
         plane is back at 1 replica: scale-up to 3, brownout rungs entered
         and left LIFO, scale-down to 1, no two actions inside the cooldown,
         none failed.
 23. drives the control plane on the card (the cost-weight sweep, the
     calibration report and the H100 refit, the selector under both
     families, the live exporter, the capacity planner).
 24. drives the process fleet on the card: TIMIT's plan (phase 19's seed-0
     fit, 8 buckets) shipped to 2 plane processes (``FleetRouter``, 1
     replica a plane), each its own CUDA context:
       - (a) every bucket's rows served through the fleet bit-equal to the
         parent's batch apply of the plan, the ship's skeleton pickled from
         the host, each plane launching ``cosine_features`` and
         ``row_stable_matmul`` (its own counters, summed over the planes as
         the kernels line's ``fleet_launches``); boot seconds by stage and
         the card's memory a plane;
       - (b) plane0 SIGKILLed halfway through a 200 Hz open-loop storm of
         3 s: the books exact, every failure ``FleetPlaneDied``, a respawn
         with a new pid, the card's free memory back; respawn seconds and
         the merged p99;
       - (e) the seed-1 fit offered as a canary to both planes (published,
         fingerprints switched, rows bit-equal to its plan), then a ship
         corrupted by a ``fleet.rpc.send`` corrupt rule quarantines its
         plane;
       - (d) ``tools.fleet_chaos``'s drill on (a)'s fleet (4 tenants at
         200 Hz, the first plane SIGKILLed halfway): ``books_balance`` and
         ``respawn_fired``;
       - (c) ``run.py serve --fleet 2`` at MnistRandomFFT's defaults at
         200 Hz (exit 0, the fleet's books, none failed).
     The planes are spawned (a forked child cannot use CUDA once the parent
     has), so they re-import this script as ``__mp_main__``: it does no
     work at module level.
 25. The one-host mesh (``parallel/mesh.py``) with 8 shards on the card:
     each kernel of the mesh path held to its plain version at the shard
     shapes; (a) TIMIT ``--solver block`` on rows sharded over the mesh
     (``Dataset.shard``), its weights held to phase 2's apply-first fit;
     (b) ``streaming_bcd_fit_mesh_centered`` on the cosine bank against
     ``streaming_bcd_fit_centered``; (c) the block-streamed tier's mesh
     form against its one-device form on 32,668 rows padded to 32,768;
     (d) ``tools.multichip``'s leg, parity within 5e-5. Each part's
     launches are counted from 0 and checked; the kernels line carries
     them as ``mesh_launches``.
 26. The ring tier (``parallel/ring.py``) with 8 shards on the card, the
     two Gaussian kernels held to their plain versions and timed at the
     shard shapes: (a) ``KernelRidgeRegression`` at RandomPatchCifarKernel's
     KRR width (n = 50,000, d = 1,800, k = 10, 98 blocks of 512, gamma
     5e-4, lambda 10, 1 epoch) on sharded rows, the mesh sweep
     (``gaussian_resid_block`` once a shard a step: 784; the pre-pass's
     ``gaussian_kernel_block`` once a block on the first device: 98), its
     weights against the one-device fit's; (b) the ring apply of that model
     on 12,500 test rows (64 launches) against its one-device apply; (c)
     ``ring_pairwise_gaussian`` on 16,384 rows (64 launches, a 1.07 GB
     output) against one launch over all rows; (d) ``ring_gram`` on
     50,000 x 1,800 against float64 sums and ``ring_attention`` at n =
     16,384, d = 128 (causal, ``n_valid``, bf16 operands) against float64
     attention; (e) one ``profile=True`` epoch (its phases and a line a
     block logged) and a ``kernel_dtype="bf16x3"`` fit against the f32
     fit; (f) HOG and DAISY on 1,000 CIFAR-sized images,
     ``PerClassWeightedLeastSquaresEstimator`` at VOC's 5,011 x 4,096 with
     20 classes and ``StreamedZCAWhitenerEstimator`` on 500,000 CIFAR
     patches from disk shards (under ``build/``, removed at the end), each
     against the same call on the CPU. (a)-(c)'s launches join the kernels
     line's ``mesh_launches``. As
     in phase 25, shards on one card run in turn: their walls are no
     evidence of scaling.
 27. The multi-process mesh: (a) two fresh interpreters (this script with
     ``--phase27-worker``, spawned after every kernel is built, so they
     only load them) join a gloo group through a ``file://`` store under
     ``build/`` and each drive 4 shards on ``cuda:0`` under
     ``make_hybrid_mesh((4,), (2,), ("data",))``: phase 26's KRR fit on
     each process's half of the seeded rows (``gaussian_resid_block`` 392
     and ``gaussian_kernel_block`` 98 in each process) and the ring apply
     on 12,500 test rows (32 a process), each bit for bit against this
     process's 8-shard mesh; a float64 normal-equations solve on the card
     within 1e-9 of numpy and the Stupid Backoff count exchange
     (``process_allgather``); each child holds the kernels it launched to
     their plain versions at its shapes. NCCL refuses two ranks on one
     device; one rank a card is not run. (b) ``tools.multichip --scaling``
     at 25(d)'s geometry, ``device_evidence: false``, ``gram_corr_sym_acc``
     counted a leg; (c) ``run_lbfgs_gram_hybrid`` at the Amazon geometry
     (64 chunks of 65,536 rows, 27 resident, 37 from disk shards under
     ``build/``, segments of 16) against ``run_lbfgs_gram_streamed`` over
     the same chunks, bit for bit, 64 launches each; (d)
     ``utils.profiling.compiled_cost`` of a 4,096³ product reads 2mnk.
     The kernels line carries the counts as ``multiprocess_launches``.

Each phase's seconds and the whole script's are logged. Phase 1 also times each bf16 form beside its library call (bf16 operands
through ``addmm`` with float32 output) and reads ``gram_corr_sym_acc``'s
bf16 and float32 forms against float64 sums on one Amazon chunk.

Prints the card's name and power limit, one JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``. Any failed phase
raises and the script exits non-zero without that line. It needs one CUDA
device and exits non-zero without one.
"""

import importlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): float32 outside
# the tensor cores, bf16 tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# bf16 gram_corr_sym_acc's output on row8_bits's fixed Amazon chunk, as the
# build of its kernel before the tensor-core mainloop moved to
# csrc/gram_wgmma.cuh gave it (H100 80GB HBM3): the move keeps its bits.
ROW8_BF16_SHA256 = "5b49275ed2095d38aed26e5d3d88bd8a2e2aa9b272fa6efe6e17b3fb427c3c1a"
# bf16 gram_sym_acc at 65,536 x 16,384 against float64 sums: at most this
# share of the sums' scale (gram_corr_sym_acc's bf16 form read 1.4e-5).
ROW7_F64_TOL = 2e-5
# The same reading of the FP32-FMA tile that bf16 F took before it moved to
# the tensor cores (scripts/torch_bf16_gram.py, H100 80GB HBM3).
ROW7_F64_PARENT = "4.306e-06"

# The TIMIT slice at the bench headline's width.
N_TRAIN, D_IN, BLOCK, NUM_COSINES, K, EPOCHS = 65536, 440, 4096, 4, 147, 3

# The README quick start: one 440 -> 4096 cosine featurizer, block 1024.
QS_WIDTH, QS_BLOCK = 4096, 1024

# The window the column-window kernels are checked on: F as wide as the
# slice's features, the third of its four blocks.
D_FEAT, COL_START = NUM_COSINES * BLOCK, 2 * BLOCK

# The streamed route: 275,000 training rows, tiles of 32,768 rows
# (pick_tile_rows(16384, 4)): 8 full tiles and a ragged 12,856-row one.
STREAM_N, STREAM_TILE = 275000, 32768

# --solver auto past the memory wall: 1,310,720 training rows, 40 tiles of
# 32,768 (pick_tile_rows(16384, 4) at the 2 GiB slab the card's budget
# gives). The fit makes one cosine bank launch a tile and folds each tile
# once; the train apply featurizes 40 tiles, the test apply of 327,680 rows
# 10; the selector's sample collector featurizes 3 rows through each of the
# four branches before the featurizer is fused.
AUTO_WALL_N = 1310720
AUTO_WALL_TILES = AUTO_WALL_N // STREAM_TILE
AUTO_WALL_COSINES = NUM_COSINES + 2 * AUTO_WALL_TILES + (AUTO_WALL_N // 4) // STREAM_TILE
# Phase 11(c): the bf16 routes on the same rows. A bf16 bank's 2 GiB slab
# holds 65,536 rows of 16,384 features: 20 tiles. Weights within 5e-3
# relative of the float32 fits (bf16 rounding of the features; the CPU
# reads 2.4e-3 and 2.6e-3 at a sixteenth of the width).
BF16_TILE = 65536
BF16_ROUTE_TOL = 5e-3

# --solver auto at the reference's default width (TimitPipeline.scala's
# numCosines = 50: d = 204,800) on 131,072 training rows, past both walls:
# the block-streamed tier with block 4,096 (50 blocks), 3 epochs. The
# selector's sample featurizes 3 rows through each of the 50 branches; the
# fit makes one cosine slab a block step (150), epoch 1 one gram_corr_sym a
# block, later epochs one block_corr a block, every step one residual
# update; the fitted model applies in tiles of pick_tile_rows(204800, 4) =
# 2,560 rows: 52 train tiles and 13 of the 32,768 test rows.
WIDE_COSINES, WIDE_N, WIDE_TILE = 50, 131072, 2560
WIDE_D, WIDE_BLOCKS = WIDE_COSINES * BLOCK, WIDE_COSINES
WIDE_LAUNCHES = {
    "cosine_features": WIDE_COSINES + EPOCHS * WIDE_BLOCKS + -(-WIDE_N // WIDE_TILE)
    + -(-(WIDE_N // 4) // WIDE_TILE),
    "gram_corr_sym": WIDE_BLOCKS, "block_gram_sym": 0, "block_corr": (EPOCHS - 1) * WIDE_BLOCKS,
    "block_residual_update": EPOCHS * WIDE_BLOCKS, "gram_sym_acc": 0,
    "gaussian_kernel_block": 0, "gaussian_resid_block": 0, "conv_featurize": 0,
    "gram_corr_sym_acc": 0, "gram_corr": 0, "countsketch_scatter": 0,
}
# The reference's formula prices the block tier under what the run
# allocates: the run's peak less what was allocated before it read 9.832
# GiB, 1.099x the priced 8.944 GiB (H100 80GB HBM3, 700 W). A run that
# holds a second slab (2.0 GiB) or a second stash (6.3 GiB) goes past this.
WIDE_PEAK_OVER_PRICED = 0.20
# One float32 block slab at the north-star n (2.2e6 rows, a 589,824-row
# shard of them): 589,824 x 4,096 = 2.42e9 elements, past 2^31.
BIG_N = 589824
# gram_corr_sym's float32 sums of BIG_N cosine products against float64
# ones on the card, as max |err| / max |f64|: at most F64_OVER_CUBLAS times
# cuBLAS's float32 reading in the same run, and under these limits (twice
# the readings of one fmaf chain an entry, H100 80GB HBM3, 700 W: Gramian
# 2.853e-4, correlation 3.255e-5; cuBLAS's 1.033e-4 and 4.409e-6). Also at
# the north star's NORTH_N rows: a 36 GB float32 slab of BLOCK columns.
GRAM_F64_TOL, CORR_F64_TOL = 6e-4, 7e-5
F64_OVER_CUBLAS = 1.25
NORTH_N = 2200000

# The CIFAR runners at their own width (keystone_tpu/pipelines/cifar.py):
# 50,000 training and 12,500 test images of 32 x 32 x 3, 100 filters of
# 6 x 6 x 3 (d = 108), 27 x 27 outputs, 2 x 100 rectified channels pooled
# 3 x 3: 1,800 features; 10 classes; blocks of 512 (KRR's and the block
# solver's), 1 epoch. RandomPatchCifarKernel is phases 6-7, the other four
# runners phase 17.
CIFAR_N, CIFAR_TEST, CIFAR_FILTERS, CIFAR_D, CIFAR_K = 50000, 12500, 100, 1800, 10
CIFAR_BLOCK, CIFAR_GAMMA = 512, 5e-4
CIFAR_BLOCKS = -(-CIFAR_N // CIFAR_BLOCK)  # 98: 97 full and one of 336 rows
# Bytes per image of the fused featurizer's input and intermediates
# (images, convolution, rectifier, pool, vector), which size its row chunks.
CONV_ROW_BYTES = 4 * (32 * 32 * 3 + 27 * 27 * 100 + 27 * 27 * 200 + 2 * 3 * 3 * 200)
# RandomPatchCifarAugmented (cifar.py:265-345) at the same width: 8 random
# 24 x 24 training crops an image (400,000), the 5 centre and corner crops
# of each test image (62,500; synthetic data: no flips), 19 x 19 outputs
# pooled 2 x 2: 800 features, blocks of 512 and 288 (the stepwise fit).
AUG_SIZE, AUG_PATCHES, AUG_TEST_PATCHES, AUG_OUT, AUG_D = 24, 8, 5, 19, 800
AUG_ROW_BYTES = 4 * (AUG_SIZE * AUG_SIZE * 3 + AUG_OUT * AUG_OUT * 100
                     + AUG_OUT * AUG_OUT * 200 + 2 * AUG_D)
# Nyström KRR on RandomPatchCifar's standardised 50,000 x 1,800 training
# features: NystromKernelRidge(GaussianKernelGenerator(5e-4), lam=10,
# num_landmarks=2048), k-means++ and uniform landmarks. Its alpha against
# a float64 solve of the same normal equations from the same K_nm.
NYS_M, NYS_LAM, NYS_F64_TOL = 2048, 10.0, 1e-3
# NewsgroupsPipeline at 20 Newsgroups' split sizes (bydate: 11,314 training
# and 7,532 test documents, 20 classes), bigrams, on synthetic_documents;
# StupidBackoffPipeline on synthetic_sentences(100,000), n = 3, alpha 0.4,
# its vectorised scorer held to the dict loop on 10,000 sampled n-grams.
NEWS_N, NEWS_TEST, NEWS_CLASSES = 11314, 7532, 20
SB_SENTENCES, SB_ORDER, SB_ALPHA, SB_SAMPLE = 100000, 3, 0.4, 10000

# The sparse slice at the Amazon geometry of the reference's bench row
# (bench.py:1212-1300): d = 16,384 features and the intercept lane, 82
# active features a row, k = 2 (±1 one-hot), λ 1e-3, 20 L-BFGS iterations
# (the AmazonReviewsPipeline default), 500,000 resident rows in chunks of
# 65,536: 7 full chunks and a ragged one of 41,248 rows.
AMAZON_N, AMAZON_D, AMAZON_NNZ, AMAZON_K = 500000, 16384, 82, 2
AMAZON_LAM, AMAZON_ITERS, AMAZON_CHUNK = 1e-3, 20, 65536
AMAZON_CHUNKS = -(-AMAZON_N // AMAZON_CHUNK)
AMAZON_RAGGED = AMAZON_N - (AMAZON_CHUNKS - 1) * AMAZON_CHUNK
# The streamed fit: 8 resident chunks (524,288 rows), folded whole and in
# segments of 3 (the last segment two live chunks and one past the end).
STREAM_CHUNKS, STREAM_SEG = 8, 3

# The sketched tier on the same rows: the reference's frontier sweep
# (bench.py:1401-1415): sketch sizes 2(d+1) and 4(d+1), 3 outer IHS
# iterations, 12 SRHT PCG iterations, seed 7. IHS folds chunks of 65,536
# rows (8 a pass), SRHT sketches chunks of 8,192 (62).
SKETCH_M, SKETCH_OUTER, SKETCH_PCG, SKETCH_SEED = 2 * (AMAZON_D + 1), 3, 12, 7
# The CountSketch kernel's small check geometry (bench.py:1445-1481).
CS_SMALL = (2048, 16, 512, 256)

# MnistRandomFFT at its own width (keystone_tpu/pipelines/mnist_random_fft.py):
# 784 inputs, 4 random-sign padded FFTs of width 1,024 (512 real bins each:
# 2,048 features), one block of 2,048, 1 epoch, λ 0, 10 classes; 60,000
# training and 10,000 test rows of synthetic_mnist. Apply first (the
# reference's run) the fit is one gram_corr_sym launch; fit first it is one
# launch of each window kernel (the reference's Pallas kernels traced on the
# CPU: the same).
MNIST_N, MNIST_TEST, MNIST_FFTS, MNIST_BLOCK, MNIST_K = 60000, 10000, 4, 2048, 10
MNIST_LAUNCHES = {
    False: {"gram_corr_sym": 1},
    True: {"block_gram_sym": 1, "block_corr": 1, "block_residual_update": 1},
}
# AmazonReviewsPipeline on synthetic_documents: 200,000 training and 50,000
# test documents, 2-grams, 1,000 common features, 20 L-BFGS iterations; its
# L-BFGS held card against CPU on the first 2,000 documents.
AMAZON_DOCS, AMAZON_FEATURES, AMAZON_LR_ITERS, AMAZON_SMALL = 200000, 1000, 20, 2000
# Per-step loss of the card's L-BFGS against the CPU's: the tolerance the CPU
# tests hold the port to the reference with on the pipeline's own features
# (tests/test_torch_amazon_slice.py, 2,000 documents: 9.96e-5 measured at
# the last step; the documents are separable and the loss falls 5,000x).
LBFGS_TOL = 2e-4

# VOCSIFTFisher at VOC 2007's sizes (5,011 train and 4,952 test images, 20
# classes) and KeystoneML's width: descDim 80, vocab 256, so d = 2 * 80 *
# 256 = 40,960 in ten blocks of 4,096, lambda 0.5, one epoch; SIFT step 3,
# bin 4, 4 scales, scale step 1. Cut: 64 x 64 synthetic images (VOC's are
# about 500 x 375), 499 descriptors an image. The stacked block fit is one
# gram_corr_sym launch a block at 5,011 x 4,096, k = 20.
VOC_N, VOC_TEST, VOC_SIZE, VOC_DESC, VOC_VOCAB, VOC_BLOCK, VOC_LAM = (
    5011, 4952, 64, 80, 256, 4096, 0.5)
VOC_K, VOC_D = 20, 2 * 80 * 256
VOC_BLOCKS = VOC_D // VOC_BLOCK
# ImageNetSiftLcsFV at the reference config's widths (SIFT and LCS PCA 64,
# vocab 16: d = 2 * (2 * 64 * 16) = 4,096, one block; lambda 6e-5, mixture
# weight 0.25, one iteration) and all 1,000 classes. Cut: 16 training and 5
# test images a class (16,000 and 5,000) of 64 x 64.
INET_N, INET_TEST, INET_CLASSES, INET_SIZE = 16000, 5000, 1000, 64
# The fit's weights on the main path's features against the same fit with
# its kernels swapped for their plain versions (cuBLAS) on the card.
VOC_PLAIN_TOL = 1e-4

# Each kernel, and the main-path route whose launches the JSON line reports.
FLAT, STACKED = "timit fused flat fit (fit first)", "timit stacked fit (apply first)"
STREAMED = "timit streamed fit (--solver streaming)"
CIFAR = "cifar RandomPatchCifarKernel (fit, then train and test apply)"
SPARSE = "amazon sparse ridge, SparseLBFGSwithL2 gram engine with bf16 slabs (fit, then apply)"
SKETCH = "amazon sketched tier, IterativeHessianSketch m = 65,540, 3 outer (fit, then apply)"
SYM_FALSE = "stacked BCD block update with sym=False at TIMIT width"
LEARN = "learn: run.py learn, the lifecycle gate, the row-stable product"
AUTO_RESIDENT = "timit --solver auto, resident: the block chain (fit first)"
AUTO_WALL = "timit --solver auto, past the memory wall: the streamed fit (fit first)"
BF16_ROUTES = "bf16 Gramians on their routes: the streamed fit's bank and the flat fit's slab"
WIDE_AUTO = "timit --solver auto at d = 204,800: the block-streamed tier (fit first)"
BLOCK_RESIDENT = "BlockStreamedLeastSquares on phase 2's rows against --solver block"
MNIST_APPLY_FIRST = "mnist MnistRandomFFT (apply first, the reference's run)"
MNIST_FIT_FIRST = "mnist MnistRandomFFT (fit first)"
AMAZON_TEXT = "amazon AmazonReviewsPipeline (text front end, logistic L-BFGS)"
VOC = "voc VOCSIFTFisher (d = 40,960, stacked block fit)"
IMAGENET = "imagenet ImageNetSiftLcsFV (1,000 classes, BWLS)"
KERNELS = {
    "cosine_features": dict(
        source="keystone_tpu_torch/csrc/cosine_features.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:391", path=FLAT,
    ),
    "gram_corr_sym": dict(
        source="keystone_tpu_torch/csrc/gram_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:589", path=STACKED,
    ),
    "block_gram_sym": dict(
        source="keystone_tpu_torch/csrc/gram_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:704", path=FLAT,
    ),
    "block_corr": dict(
        source="keystone_tpu_torch/csrc/block_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:978", path=FLAT,
    ),
    "block_residual_update": dict(
        source="keystone_tpu_torch/csrc/block_residual_update.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:1030", path=FLAT,
    ),
    "gram_sym_acc": dict(
        source="keystone_tpu_torch/csrc/gram_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:769", path=STREAMED,
    ),
    "gaussian_kernel_block": dict(
        source="keystone_tpu_torch/csrc/gaussian_kernel_block.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:164", path=CIFAR,
    ),
    "gaussian_resid_block": dict(
        source="keystone_tpu_torch/csrc/gaussian_resid_block.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:266", path=CIFAR,
    ),
    "conv_featurize": dict(
        source="keystone_tpu_torch/csrc/conv_featurize.cu",
        replaces="keystone_tpu/ops/pallas_images.py:118", path=CIFAR,
    ),
    "gram_corr_sym_acc": dict(
        source="keystone_tpu_torch/csrc/gram_corr_sym_acc.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:881", path=SPARSE,
    ),
    "gram_corr": dict(
        source="keystone_tpu_torch/csrc/gram_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:485", path=SYM_FALSE,
    ),
    "countsketch_scatter": dict(
        source="keystone_tpu_torch/csrc/countsketch_scatter.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:1120", path=SKETCH,
    ),
    "row_stable_matmul": dict(
        source="keystone_tpu_torch/csrc/row_stable_matmul.cu",
        replaces="none: no TPU twin, ROADMAP C.8's repair", path=LEARN,
    ),
}
# Launches of the flat route: 4 blocks, 3 epochs, Gramians stashed after
# the first epoch; 4 cosine branches in the fit and in each of two applies.
FLAT_LAUNCHES = {
    "cosine_features": 3 * NUM_COSINES, "gram_corr_sym": 0,
    "block_gram_sym": D_FEAT // BLOCK, "block_corr": EPOCHS * D_FEAT // BLOCK,
    "block_residual_update": EPOCHS * D_FEAT // BLOCK, "gram_sym_acc": 0,
    "gaussian_kernel_block": 0, "gaussian_resid_block": 0, "conv_featurize": 0,
    "gram_corr_sym_acc": 0, "gram_corr": 0, "countsketch_scatter": 0,
}
# Launches of the streamed route: one fold per row tile (9), one cosine bank
# launch per tile in the fit (9), the train apply (9) and the test apply of
# 68,750 rows (3).
STREAM_TILES = -(-STREAM_N // STREAM_TILE)
STREAMED_LAUNCHES = {
    "cosine_features": 2 * STREAM_TILES + -(-(STREAM_N // 4) // STREAM_TILE),
    "gram_corr_sym": 0, "block_gram_sym": 0, "block_corr": 0, "block_residual_update": 0,
    "gram_sym_acc": STREAM_TILES, "gaussian_kernel_block": 0, "gaussian_resid_block": 0,
    "conv_featurize": 0, "gram_corr_sym_acc": 0, "gram_corr": 0, "countsketch_scatter": 0,
}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """Device time of ``fn`` a call, without the host's time between its
    launches (which decides a short call's ``time_ms``): ``reps`` calls are
    queued behind a spin kernel of about 50 ms, so the card runs every
    launch of every call back to back, and CUDA events around them give
    their time over ``reps``. Raises if the spin ended before the last call
    was queued. (``torch.profiler`` lost records of this port's kernels late
    in this script's process, 19 of 20 launches traced while a torch kernel
    in the same trace kept all 20, so its sums read short.)"""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    queued_in_time = not start.query()
    end.record()
    end.synchronize()
    if not queued_in_time:
        raise RuntimeError(f"device_ms: the card caught up with the host in {reps} calls")
    return start.elapsed_time(end) / reps


def cifar_gaussian_shapes(X, xn, Xt, xtn):
    """gaussian_kernel_block's shapes on the CIFAR route, label -> (X, Y,
    X's norms, Y's norms, whether it is a diagonal block), from the
    training rows X and test rows Xt with their squared norms: one 512-row
    train block against all training rows (the train apply) and against
    the test rows (the test apply), a diagonal block of the pre-pass, and
    the ragged last one (336 rows)."""
    n = CIFAR_BLOCK
    Y, yn = X[2 * n:3 * n], xn[2 * n:3 * n]
    last = (CIFAR_BLOCKS - 1) * n
    return {
        "train apply": (X, Y, xn, yn, False),
        "test apply": (Xt, Y, xtn, yn, False),
        "diagonal": (X[:n], X[:n], xn[:n], xn[:n], True),
        "ragged diagonal": (X[last:], X[last:], xn[last:], xn[last:], True),
    }


def bound_ms(nbytes, flops, peak_flops):
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / peak_flops * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def bf16_mm(a, b, c=None, **kw):
    """The library yardstick of a bf16-operand form: ``c + a @ b`` (``c``
    None: zeros, not added) on the tensor cores, bf16 operands (a float32
    one rounded to bf16) accumulating into and returning float32."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if c is None:
        c = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
        kw["beta"] = 0
    return torch.addmm(c, a, b, out_dtype=torch.float32, **kw)


def sass_count(cuda_ops, name, opcode):
    """The number of SASS instructions naming ``opcode`` in a built kernel
    library (``cuobjdump -sass``), or None where the toolkit lacks it."""
    tool = os.path.join(os.path.dirname(cuda_ops._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(cuda_ops._library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for line in sass.splitlines() if opcode in line)


def without_parameters(name):
    """A demangled function name without its trailing parameter list (the
    last balanced ``(...)``), template arguments such as ``(int)10`` kept."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() if name[i] == "(" else name
    return name


def ptxas_lines(cuda_ops, report):
    """One line a kernel function of an ``nvcc -Xptxas -v`` report: its
    name (demangled by the toolkit's ``cu++filt`` where there is one, its
    parameter list cut), registers and spill bytes; and every error or
    warning line."""
    filt = os.path.join(os.path.dirname(cuda_ops._nvcc()), "cu++filt")
    lines, name, spills = [], None, ""
    for line in report.splitlines():
        if "error" in line or "warning" in line:
            lines.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip()
            name = without_parameters(name)
        elif "spill stores" in line:
            spills = ", ".join(part.strip() for part in line.split(",")[1:])
        elif "registers" in line and name is not None:
            regs = line.split("Used ")[1].split(",")[0]
            lines.append(f"{name}: {regs}, {spills}")
            name = None
    return lines


def check(name, ok, detail):
    log(f"  {'PASS' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


# Launched by every float32 linear model's batch apply and exported plan
# (the mappers' row-stable product), in numbers that follow each apply's
# row chunks and, when serving, its batches: the routes' launch checks
# hold the other kernels exactly and log this one's count beside them;
# phases 18(d), 19(a) and 20 hold it exactly where the count is fixed.
ROW_STABLE = "row_stable_matmul"


def same_launches(counts, want):
    """A route's launch counts equal ``want`` (a kernel it leaves out: 0)
    for every kernel but the row-stable product (see ROW_STABLE)."""
    return all(v == want.get(k, 0) for k, v in counts.items() if k != ROW_STABLE)


def phase_kernels(cuda_ops):
    """Each kernel against its plain version at the slice's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # cosine_features: one branch of the training featurization.
    m, d, n = N_TRAIN, D_IN, BLOCK
    X = torch.randn((m, d), generator=gen, device=dev) * 0.6
    W = torch.randn((n, d), generator=gen, device=dev) * 0.05555
    b = torch.rand((n,), generator=gen, device=dev) * 6.283185307179586
    for label, compute, out, tol in (
        ("f32", torch.float32, torch.float32, 1e-5),
        ("bf16 operands", torch.bfloat16, torch.float32, 1e-5),
        ("bf16 output", torch.float32, torch.bfloat16, 2.0 ** -7),
    ):
        got = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        again = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        want = cuda_ops.cosine_features_ref(X, W, b, compute, out)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(f"cosine_features {label} {m}x{d} @ {n}x{d}", err <= tol and torch.equal(got, again),
              f"max_abs_err {err:.3e} (tol {tol:.1e}), the same bits on a second call")
        if label == "f32":
            results["cosine_features"] = dict(max_abs_err=err)
        del got, again, want
    nbytes = 4 * (m * d + n * d + n + m * n)
    flops = 2 * m * n * d + 16 * m * n  # GEMM + bias add, range reduction, polynomial
    r = results["cosine_features"]
    r["ms"] = time_ms(lambda: cuda_ops.cosine_features(X, W, b), 10)
    r["device_ms"] = device_ms(lambda: cuda_ops.cosine_features(X, W, b), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.cosine_features_ref(X, W, b), 10)
    r["library_ms"] = time_ms(lambda: torch.cos(torch.addmm(b, X, W.T)), 10)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    X16, W16 = X.to(torch.bfloat16), W.to(torch.bfloat16)
    bf16_ms = r["bf16_ms"] = time_ms(lambda: cuda_ops.cosine_features(X16, W16, b), 5)
    r["bf16_library_ms"] = time_ms(lambda: torch.cos(bf16_mm(X16, W16.T, b)), 5)
    bf16_bound = r["bf16_bound_ms"] = bound_ms(2 * (m * d + n * d) + 4 * (n + m * n), flops,
                                               PEAK_BF16_FLOPS)[0]
    # The flat route's call: the branch written into its column window of
    # the (m, 4 n) fused feature matrix.
    fused = torch.empty((m, NUM_COSINES * n), device=dev)
    window = fused[:, COL_START:COL_START + n]
    r["window_ms"] = time_ms(lambda: cuda_ops.cosine_features(X, W, b, out=window), 10)
    check("cosine_features into its column window of the fused matrix",
          torch.equal(window, cuda_ops.cosine_features(X, W, b)),
          "the bits of a fresh output")
    del fused, window
    grid = r["grid"] = cuda_ops.cosine_features_grid(m, n, d, False, False, dev)
    log(f"  cosine_features f32: {r['ms']:.3f} ms a call, {r['device_ms']:.3f} ms on the device "
        f"(into the fused matrix's window {r['window_ms']:.3f}; plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 operands: {bf16_ms:.3f} ms (library {r['bf16_library_ms']:.3f}, bound "
        f"{bf16_bound:.3f}); grid {grid['tiles']} tiles, {grid_line(grid)}")
    check("cosine_features spills nothing", grid["local_bytes"] == 0,
          f"{grid['local_bytes']} local bytes a thread, {grid['registers']} registers")

    # gram_corr_sym: one centered 4096-wide feature block and the residual.
    A = cuda_ops.cosine_features(X, W, b)
    A -= A.mean(dim=0)
    labels = torch.randint(0, K, (m,), generator=gen, device=dev)
    R = 2.0 * torch.nn.functional.one_hot(labels, K).float() - 1.0
    R -= R.mean(dim=0)
    del X, W, X16, W16
    d, k = BLOCK, K
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ak = A.to(dtype)
        gram, corr = cuda_ops.gram_corr_sym(Ak, R)
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(Ak, R)
        torch.cuda.synchronize()
        g_err = (gram - gram_r).abs().max().item()
        c_err = (corr - corr_r).abs().max().item()
        # Errors relative to the scale of the sums, max over entries of
        # sum_r |a_ri| |y_rj|: the centered entries cancel, so their own
        # size says nothing of the rounding. For the Gramian that scale is
        # its largest diagonal entry. Two f32 sums of 65,536 terms in
        # different orders differ by about sqrt(n) * 2^-24 of it.
        g_rel = g_err / gram_r.diagonal().max().item()
        c_rel = c_err / (Ak.float().abs().T @ R.abs()).max().item()
        check(f"gram_corr_sym {label} A {m}x{d}, R {m}x{k}",
              g_rel <= 1e-4 and c_rel <= 1e-4 and torch.equal(gram, gram.T),
              f"gram max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err "
              f"{c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale, symmetric")
        if label == "f32":
            results["gram_corr_sym"] = dict(max_abs_err=max(g_err, c_err))
        del Ak, gram, corr, gram_r, corr_r
    nbytes = 4 * (m * d + m * k + d * d + d * k)
    flops = m * d * (d + 1) + 2 * m * d * k  # upper triangle (syrk) + correlation
    r = results["gram_corr_sym"]
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr_sym(A, R), 5)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_ref(A, R), 5)
    r["library_ms"] = time_ms(lambda: (A.T @ A, A.T @ R), 5)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    A16 = A.to(torch.bfloat16)
    bf16_ms = r["bf16_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym(A16, R), 3)
    r["bf16_library_ms"] = time_ms(lambda: (bf16_mm(A16.T, A16), bf16_mm(A16.T, R)), 3)
    bf16_bound = r["bf16_bound_ms"] = bound_ms(2 * m * d + 4 * (m * k + d * d + d * k), flops,
                                               PEAK_BF16_FLOPS)[0]
    log(f"  gram_corr_sym f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 operands: {bf16_ms:.3f} ms (library {r['bf16_library_ms']:.3f}, bound "
        f"{bf16_bound:.3f})")
    results["gram_corr"] = phase_gram_corr(cuda_ops, A, R)
    del A, A16, R
    torch.cuda.empty_cache()
    r["voc_shape"] = phase_voc_gram(cuda_ops, gen)
    results.update(phase_window_kernels(cuda_ops, gen))
    results.update(phase_gram_sym_acc(cuda_ops, gen))
    results.update(phase_gram_corr_sym_acc(cuda_ops, gen))
    results["countsketch_scatter"] = phase_countsketch(cuda_ops)
    return results


def phase_voc_gram(cuda_ops, gen):
    """``gram_corr_sym`` at the VOC fit's shape (one centred 5,011 x 4,096
    feature block, k = 20 centred ±1 labels: ten launches in phase 15)
    against its plain version, timed beside it and ``A.T@A``, ``A.T@R``,
    with its bound and grid. n is not a multiple of the 2,048-row Gramian
    chunk: two whole chunks and a ragged one."""
    dev = torch.device("cuda")
    m, d, k = VOC_N, VOC_BLOCK, VOC_K
    A = torch.randn((m, d), generator=gen, device=dev) / 64.0
    A -= A.mean(dim=0)
    labels = torch.randint(0, k, (m,), generator=gen, device=dev)
    R = 2.0 * torch.nn.functional.one_hot(labels, k).float() - 1.0
    R -= R.mean(dim=0)
    gram, corr = cuda_ops.gram_corr_sym(A, R)
    gram_r, corr_r = cuda_ops.gram_corr_sym_ref(A, R)
    _sync(A.device)
    g_err = (gram - gram_r).abs().max().item()
    c_err = (corr - corr_r).abs().max().item()
    g_rel = g_err / gram_r.diagonal().max().item()
    c_rel = c_err / (A.abs().T @ R.abs()).max().item()
    check(f"gram_corr_sym at the VOC shape, A {m}x{d}, R {m}x{k}",
          g_rel <= 1e-4 and c_rel <= 1e-4 and torch.equal(gram, gram.T),
          f"gram max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err {c_err:.3e} "
          f"({c_rel:.2e} of scale), tol 1e-4 of scale, symmetric")
    del gram, corr, gram_r, corr_r
    r = dict(rows=m, d=d, k=k, max_abs_err=max(g_err, c_err))
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr_sym(A, R), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_ref(A, R), 10)
    r["library_ms"] = time_ms(lambda: (A.T @ A, A.T @ R), 10)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * d + m * k + d * d + d * k),
                                            m * d * (d + 1) + 2 * m * d * k, PEAK_F32_FLOPS)
    grid = r["grid"] = cuda_ops.gram_corr_grid(A, k)
    log(f"  gram_corr_sym at the VOC shape: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}, "
        f"{r['bound_ms'] / r['ms']:.0%} of it); grid {grid['corr_blocks']} correlation blocks "
        f"({grid['ktile']}-wide label tile, {grid['masked']:.1%} masked) and "
        f"{grid['gram_blocks']} Gramian tiles: {grid_line(grid)}")
    del A, R
    torch.cuda.empty_cache()
    return r


def phase_gram_corr(cuda_ops, A, R):
    """The dense Gramian kernel on gram_corr_sym's operands (one centered
    4096-wide block, the residual): every tile computed, f32 and bf16 A."""
    m, d = A.shape
    k = R.shape[1]
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ak = A.to(dtype)
        gram, corr = cuda_ops.gram_corr(Ak, R)
        gram_r, corr_r = cuda_ops.gram_corr_ref(Ak, R)
        sym_gram, sym_corr = cuda_ops.gram_corr_sym(Ak, R)
        torch.cuda.synchronize()
        g_err = (gram - gram_r).abs().max().item()
        c_err = (corr - corr_r).abs().max().item()
        # Errors relative to the scale of the sums, as for gram_corr_sym.
        g_rel = g_err / gram_r.diagonal().max().item()
        c_rel = c_err / (Ak.float().abs().T @ R.abs()).max().item()
        check(f"gram_corr {label} A {m}x{d}, R {m}x{k}",
              g_rel <= 1e-4 and c_rel <= 1e-4 and torch.equal(gram, gram.T)
              and torch.equal(gram, sym_gram) and torch.equal(corr, sym_corr),
              f"gram max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err "
              f"{c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale; symmetric, and the "
              f"bits of gram_corr_sym's mirrored Gramian and correlation")
        if label == "f32":
            r = dict(max_abs_err=max(g_err, c_err))
        del Ak, gram, corr, gram_r, corr_r, sym_gram, sym_corr
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr(A, R), 5)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_ref(A, R), 5)
    r["library_ms"] = time_ms(lambda: (A.T @ A, A.T @ R), 5)
    # The bound of the function, (AᵀA, AᵀR), not of this kernel's way of
    # computing it: the symmetric Gramian needs only its upper triangle, as
    # for gram_corr_sym.
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * d + m * k + d * d + d * k),
                                            m * d * (d + 1) + 2 * m * d * k, PEAK_F32_FLOPS)
    A16 = A.to(torch.bfloat16)
    bf16_ms = r["bf16_ms"] = time_ms(lambda: cuda_ops.gram_corr(A16, R), 3)
    r["bf16_library_ms"] = time_ms(lambda: (bf16_mm(A16.T, A16), bf16_mm(A16.T, R)), 3)
    r["bf16_bound_ms"], _ = bound_ms(2 * m * d + 4 * (m * k + d * d + d * k),
                                     m * d * (d + 1) + 2 * m * d * k, PEAK_BF16_FLOPS)
    log(f"  gram_corr f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, library "
        f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); bf16 "
        f"operands: {bf16_ms:.3f} ms (library {r['bf16_library_ms']:.3f}, bf16 bound "
        f"{r['bf16_bound_ms']:.3f})")
    r["grid"] = {}
    for label, Ak in (("f32", A), ("bf16", A16)):
        grid = cuda_ops.gram_corr_grid(Ak, k)
        r["grid"][label] = grid
        log(f"  gram_corr {label} grid: {grid['corr_blocks']} correlation blocks "
            f"({grid['ktile']}-wide label tile, {grid['masked']:.1%} masked), then "
            f"{grid['gram_blocks']} Gramian tiles: {grid_line(grid)}")
    grid = r["grid"]["f32"]
    check("gram_corr computes the upper tiles only and k in one label tile",
          grid["gram_blocks"] == (d // 128) * (d // 128 + 1) // 2 and grid["masked"] <= 0.10,
          f"{grid['gram_blocks']} Gramian blocks, {grid['masked']:.1%} masked at k = {k}")
    return r


def grid_line(grid):
    """A kernel grid's blocks, resident blocks an SM, waves, registers and
    spilled bytes a thread."""
    return (f"{grid['blocks']} blocks, {grid['blocks_per_sm']} an SM on {grid['sms']} SMs "
            f"({grid['waves']:.3f} waves), {grid['registers']} registers, "
            f"{grid['local_bytes']} local bytes a thread")


def countsketch_chunk(c, nnz, m, d, gen):
    """A CountSketch chunk made on the card: ``nnz`` sorted uniform column
    indices a row in [0, d) and standard normal values (phase 8's rows),
    then the intercept lane (column d, value 1); a uniform bucket in
    [0, m) and a ±1 sign a row."""
    dev = torch.device("cuda")
    idx = torch.randint(0, d, (c, nnz), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.cat([idx.sort(dim=1).values,
                     torch.full((c, 1), d, dtype=torch.int32, device=dev)], dim=1)
    val = torch.cat([torch.randn((c, nnz), generator=gen, device=dev),
                     torch.ones((c, 1), device=dev)], dim=1)
    bucket = torch.randint(0, m, (c,), generator=gen, device=dev, dtype=torch.int32)
    sign = torch.randint(0, 2, (c,), generator=gen, device=dev).float() * 2 - 1
    return idx, val, bucket, sign


def phase_countsketch(cuda_ops):
    """countsketch_scatter against its plain version run on the CPU (which
    adds lane after lane in (row, slot) order, the kernel's order: bit for
    bit), fresh and in place, at the reference's small check geometry and
    at the sketched tier's Amazon chunk; then its time beside the plain
    version on the card, one flattened ``index_add_`` and the bound of the
    in-place form the fold uses."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    dev = torch.device("cuda")
    c, s, m, d1 = CS_SMALL
    small = (torch.randint(0, d1, (c, s), generator=gen, device=dev, dtype=torch.int32),
             torch.randn((c, s), generator=gen, device=dev),
             torch.randint(0, m, (c,), generator=gen, device=dev, dtype=torch.int32),
             torch.randint(0, 2, (c,), generator=gen, device=dev).float() * 2 - 1)
    cases = [("small check", small, m, d1)]
    c, nnz, m, d = AMAZON_CHUNK, AMAZON_NNZ, SKETCH_M, AMAZON_D
    chunk = countsketch_chunk(c, nnz, m, d, gen)
    cases.append(("Amazon chunk", chunk, m, d + 1))
    r = {}
    for label, ops, m, d1 in cases:
        c, s = ops[0].shape
        cpu_ops = [t.cpu() for t in ops]
        out0 = torch.randn((m, d1), generator=gen, device=dev)
        fresh = cuda_ops.countsketch_scatter(*ops, m, d1)
        acc = out0.clone()
        cuda_ops.countsketch_scatter(*ops, m, d1, out=acc)
        torch.cuda.synchronize()
        want_fresh = cuda_ops.countsketch_scatter_ref(*cpu_ops, m, d1)
        same_fresh = torch.equal(fresh.cpu(), want_fresh)
        err = (fresh.cpu() - want_fresh).abs().max().item()
        del fresh, want_fresh
        want_acc = cuda_ops.countsketch_scatter_ref(*cpu_ops, m, d1, out=out0.cpu())
        same_acc = torch.equal(acc.cpu(), want_acc)
        del want_acc, acc, out0
        check(f"countsketch_scatter {label}, c {c}, s {s}, m {m}, d1 {d1}",
              same_fresh and same_acc,
              f"fresh and in place the bits of the plain version run on the CPU "
              f"(max_abs_err {err:.3e})")
        if label == "Amazon chunk":
            r["max_abs_err"] = err
    idx, val, bucket, sign = chunk
    c, s = idx.shape
    m, d1 = SKETCH_M, AMAZON_D + 1
    acc = torch.zeros((m, d1), device=dev)
    seg = (bucket.long()[:, None] * d1 + idx.long()).reshape(-1)
    src = (sign[:, None] * val).reshape(-1)
    touched = int(torch.unique(seg).numel())
    r["ms"] = time_ms(lambda: cuda_ops.countsketch_scatter(*chunk, m, d1, out=acc), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.countsketch_scatter_ref(*chunk, m, d1, out=acc),
                            10)
    r["library_ms"] = time_ms(lambda: acc.view(-1).index_add_(0, seg, src), 10)
    # In place, as the fold runs it: the operands read once, each touched
    # entry of the accumulator read and written once; no arithmetic bound.
    nbytes = 4 * (2 * c * s + 2 * c) + 8 * touched
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, c * s, PEAK_F32_FLOPS)
    # The wrapper's two steps apart: the index preparation (histogram, scan,
    # placement) and the warp-a-bucket scatter on the prepared indices; and
    # the stable torch.sort order that the preparation replaced.
    order, starts = cuda_ops.countsketch_prepare(bucket, m)
    r["prepare_ms"] = time_ms(lambda: cuda_ops.countsketch_prepare(bucket, m), 10)
    r["scatter_ms"] = time_ms(
        lambda: cuda_ops.countsketch_rows(idx, val, sign, order, starts, acc), 10)
    sort_ms = time_ms(lambda: cuda_ops.countsketch_order(bucket, m), 10)
    del acc, order, starts
    fresh_ms = time_ms(lambda: cuda_ops.countsketch_scatter(*chunk, m, d1), 3)
    fresh_bound, _ = bound_ms(nbytes + 4 * m * d1, c * s, PEAK_F32_FLOPS)
    log(f"  countsketch_scatter in place, c {c}, s {s}, m {m}, d1 {d1} ({touched} entries "
        f"touched): {r['ms']:.4f} ms (preparation {r['prepare_ms']:.4f}, scatter kernel "
        f"{r['scatter_ms']:.4f}; the torch.sort order it replaced {sort_ms:.4f}; plain "
        f"{r['plain_ms']:.3f}, library index_add_ {r['library_ms']:.4f}, bound "
        f"{r['bound_ms']:.4f} by {r['bound_by']}); fresh buffer {fresh_ms:.3f} ms "
        f"(bound {fresh_bound:.3f})")
    del chunk, idx, val, bucket, sign, seg, src
    torch.cuda.empty_cache()
    return r


def phase_window_kernels(cuda_ops, gen):
    """The flat solver's column-window kernels on one window of a
    full-width feature matrix, F 65,536 x 16,384 at column 8,192."""
    dev = torch.device("cuda")
    n, d, s, b, k = N_TRAIN, D_FEAT, COL_START, BLOCK, K
    F = torch.randn((n, d), generator=gen, device=dev)
    R = torch.randn((n, k), generator=gen, device=dev)
    dW = torch.randn((b, k), generator=gen, device=dev) * 0.01
    results = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Fk = F.to(dtype)
        Fw = Fk[:, s:s + b].float()
        # Errors relative to the scale of the sums, max over entries of
        # sum |f||r| (for the Gramian its largest diagonal entry): sums of
        # 65,536 (Gramian, correlation) or 4,096 (residual) float32 terms in
        # different orders differ by about sqrt(terms) * 2^-24 of it.
        checks = {
            "block_gram_sym": (
                cuda_ops.block_gram_sym(Fk, s, b), cuda_ops.block_gram_sym_ref(Fk, s, b),
                lambda want: want.diagonal().max().item(),
            ),
            "block_corr": (
                cuda_ops.block_corr(Fk, s, b, R), cuda_ops.block_corr_ref(Fk, s, b, R),
                lambda want: (Fw.abs().T @ R.abs()).max().item(),
            ),
            "block_residual_update": (
                cuda_ops.block_residual_update(Fk, s, b, dW, R),
                cuda_ops.block_residual_update_ref(Fk, s, b, dW, R),
                lambda want: (R.abs() + Fw.abs() @ dW.to(dtype).float().abs()).max().item(),
            ),
        }
        torch.cuda.synchronize()
        for name, (got, want, scale) in checks.items():
            err = (got - want).abs().max().item()
            rel = err / scale(want)
            ok = rel <= 1e-4 and (name != "block_gram_sym" or torch.equal(got, got.T))
            check(f"{name} {label} F {n}x{d}, window [{s}, {s + b}), k {k}", ok,
                  f"max_abs_err {err:.3e} ({rel:.2e} of scale), tol 1e-4 of scale"
                  + (", symmetric" if name == "block_gram_sym" else ""))
            if label == "f32":
                results[name] = dict(max_abs_err=err)
        del Fk, Fw, checks
    Fw = F[:, s:s + b]
    yardsticks = {
        # (kernel, plain, library call, bytes, flops)
        "block_gram_sym": (
            lambda: cuda_ops.block_gram_sym(F, s, b),
            lambda: cuda_ops.block_gram_sym_ref(F, s, b),
            lambda: Fw.T @ Fw,
            4 * (n * b + b * b), n * b * (b + 1),
        ),
        "block_corr": (
            lambda: cuda_ops.block_corr(F, s, b, R),
            lambda: cuda_ops.block_corr_ref(F, s, b, R),
            lambda: Fw.T @ R,
            4 * (n * b + n * k + b * k), 2 * n * b * k,
        ),
        "block_residual_update": (
            lambda: cuda_ops.block_residual_update(F, s, b, dW, R),
            lambda: cuda_ops.block_residual_update_ref(F, s, b, dW, R),
            lambda: torch.addmm(R, Fw, dW, alpha=-1),
            4 * (n * b + b * k + 2 * n * k), 2 * n * b * k,
        ),
    }
    F16 = F.to(torch.bfloat16)
    r = results["block_gram_sym"]
    r["grid"] = {}
    tiles = (b // 128) * (b // 128 + 1) // 2
    for label, Fk in (("f32", F), ("bf16", F16)):
        grid = r["grid"][label] = cuda_ops.block_gram_sym_grid(Fk, s, b)
        log(f"  block_gram_sym {label} F grid: {grid['blocks']} upper tiles "
            f"({tensor_core_line(grid)}), {grid_line(grid)}")
    grid = r["grid"]["f32"]
    check("block_gram_sym f32 computes the window's upper tiles only, spills nothing and holds "
          "2 blocks an SM at <= 128 registers",
          grid["blocks"] == tiles and grid["vec"] and not grid["tensor_cores"]
          and grid["local_bytes"] == 0 and grid["blocks_per_sm"] >= 2
          and grid["registers"] <= 128,
          f"{grid['blocks']} blocks, {grid['local_bytes']} local bytes, "
          f"{grid['registers']} registers, {grid['blocks_per_sm']} blocks an SM")
    check_tensor_core_grid("block_gram_sym", r["grid"]["bf16"], tiles)
    # bf16 F: the window's bits are gram_sym_acc's on G = 0, mirrored (one
    # tensor-core mainloop; 0 + x = x), and the window is read in place.
    Fw16 = F16[:, s:s + b]
    staged = dict(cuda_ops.staged)
    gram = cuda_ops.block_gram_sym(F16, s, b)
    acc = cuda_ops.gram_sym_acc(torch.zeros((b, b), device=dev), Fw16)
    link = torch.equal(gram, torch.triu(acc) + torch.triu(acc, 1).T)
    check(f"block_gram_sym bf16 has the bits of gram_sym_acc(0, F[:, {s}:{s + b}]) mirrored, "
          f"reading the window in place", link and cuda_ops.staged == staged,
          f"bitwise equal {link}, staged copies {cuda_ops.staged} (before {staged})")
    del gram, acc
    bf16_calls = {
        # (kernel, library call)
        "block_gram_sym": (lambda: cuda_ops.block_gram_sym(F16, s, b),
                           lambda: bf16_mm(Fw16.T, Fw16)),
        "block_corr": (lambda: cuda_ops.block_corr(F16, s, b, R), lambda: bf16_mm(Fw16.T, R)),
        "block_residual_update": (lambda: cuda_ops.block_residual_update(F16, s, b, dW, R),
                                  lambda: bf16_mm(Fw16, dW, R, alpha=-1)),
    }
    for name, (kernel, plain, library, nbytes, flops) in yardsticks.items():
        r = results[name]
        r["ms"] = time_ms(kernel, 5)
        r["plain_ms"] = time_ms(plain, 5)
        r["library_ms"] = time_ms(library, 5)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        r["bf16_ms"] = time_ms(bf16_calls[name][0], 3)
        r["bf16_library_ms"] = time_ms(bf16_calls[name][1], 3)
        # bf16 F: the window's bytes halve; the products on the tensor cores.
        r["bf16_bound_ms"], _ = bound_ms(nbytes - 2 * n * b, flops, PEAK_BF16_FLOPS)
        log(f"  {name} f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
            f"bf16 F: {r['bf16_ms']:.3f} ms (library {r['bf16_library_ms']:.3f}, bf16 bound "
            f"{r['bf16_bound_ms']:.3f}, {r['bf16_bound_ms'] / r['bf16_ms']:.1%} of it)")
    r = results["block_corr"]
    r["grid"] = {}
    for label, bf16 in (("f32", False), ("bf16", True)):
        grid = cuda_ops.block_corr_grid(n, b, k, bf16, dev)
        r["grid"][label] = grid
        log(f"  block_corr {label} F grid: {grid['ktile']}-wide label tile "
            f"({grid['masked']:.1%} masked), {grid['tiles']} tiles x {grid['splits']} row "
            f"chunks, {grid_line(grid)}")
    check("block_corr masks at most 10% of its label FMAs", r["grid"]["f32"]["masked"] <= 0.10,
          f"{r['grid']['f32']['masked']:.1%} at k = {k}")
    r = results["block_residual_update"]
    r["grid"] = {}
    for label, bf16 in (("f32", False), ("bf16", True)):
        grid = cuda_ops.block_residual_update_grid(n, k, bf16, dev)
        r["grid"][label] = grid
        log(f"  block_residual_update {label} F grid: {grid['ktile']}-wide label tile "
            f"({grid['masked']:.1%} masked), {grid['row_tiles']} row tiles x "
            f"{grid['label_tiles']} label tile, {grid_line(grid)}")
    grid = r["grid"]["f32"]
    check("block_residual_update stages each window tile once and masks at most 10% of its "
          "label FMAs", grid["label_tiles"] == 1 and grid["masked"] <= 0.10,
          f"{grid['label_tiles']} label tile, {grid['masked']:.1%} masked at k = {k}")
    del F, F16, Fw, Fw16, R, dW
    torch.cuda.empty_cache()
    return results


def phase_gram_sym_acc(cuda_ops, gen):
    """The streamed fold's kernel on one full row tile of the streamed fit:
    F 32,768 x 16,384, a random G0, in place and into a new buffer."""
    dev = torch.device("cuda")
    n, d = STREAM_TILE, D_FEAT
    F = torch.randn((n, d), generator=gen, device=dev)
    G0 = torch.randn((d, d), generator=gen, device=dev)
    tiles = torch.arange(d, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    results = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Fk = F.to(dtype)
        want = cuda_ops.gram_sym_acc_ref(G0, Fk)
        Ff = Fk.float()
        # Errors relative to the scale of the sums, |G0| + sum |f_i||f_j|: two
        # f32 sums of 32,768 terms in different orders differ by about
        # sqrt(n) * 2^-24 of it.
        scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
        del Ff
        G = G0.clone()
        for how, got in (("new buffer", cuda_ops.gram_sym_acc(G0, Fk)),
                         ("in place", cuda_ops.gram_sym_acc(G, Fk, out=G))):
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff[upper].max().item()
            rel = (diff / scale)[upper].max().item()
            ok = rel <= 1e-4 and (how == "new buffer" or torch.equal(G[~upper], G0[~upper]))
            check(f"gram_sym_acc {label} {how}, G0 {d}x{d}, F {n}x{d}", ok,
                  f"upper tiles max_abs_err {err:.3e} ({rel:.2e} of scale), tol 1e-4 of "
                  f"scale" + (", lower tiles untouched" if how == "in place" else ""))
            if label == "f32" and how == "in place":
                results["gram_sym_acc"] = dict(max_abs_err=err)
            del diff, got
        del Fk, want, scale, G
    G = G0.clone()
    r = results["gram_sym_acc"]
    r["ms"] = time_ms(lambda: cuda_ops.gram_sym_acc(G, F, out=G), 5)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_sym_acc_ref(G0, F), 5)
    r["library_ms"] = time_ms(lambda: torch.addmm(G0, F.T, F), 5)
    flops = n * d * (d + 1)  # the upper triangle (syrk)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (n * d + 2 * d * d), flops, PEAK_F32_FLOPS)
    F16 = F.to(torch.bfloat16)
    bf16_ms = r["bf16_ms"] = time_ms(lambda: cuda_ops.gram_sym_acc(G, F16, out=G), 3)
    r["bf16_library_ms"] = time_ms(lambda: bf16_mm(F16.T, F16, G0), 3)
    r["bf16_bound_ms"], _ = bound_ms(2 * n * d + 8 * d * d, flops, PEAK_BF16_FLOPS)
    log(f"  gram_sym_acc f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 F: {bf16_ms:.3f} ms, {flops / bf16_ms / 1e9:.1f} TFLOP/s (library "
        f"{r['bf16_library_ms']:.3f}, bf16 bound {r['bf16_bound_ms']:.3f}, "
        f"{r['bf16_bound_ms'] / bf16_ms:.1%} of it)")
    r["grid"] = {}
    tiles = -(-d // 128) * (-(-d // 128) + 1) // 2
    for label, Fk in (("f32", F), ("bf16", F16)):
        grid = r["grid"][label] = cuda_ops.gram_sym_acc_grid(Fk)
        log(f"  gram_sym_acc {label} F grid: {grid['blocks']} upper tiles "
            f"({tensor_core_line(grid)}), {grid_line(grid)}")
    grid = r["grid"]["f32"]
    check("gram_sym_acc f32 computes the upper tiles only, spills nothing and holds 2 blocks an "
          "SM at <= 128 registers",
          grid["blocks"] == tiles and grid["vec"] and not grid["tensor_cores"]
          and grid["local_bytes"] == 0 and grid["blocks_per_sm"] >= 2
          and grid["registers"] <= 128,
          f"{grid['blocks']} blocks, {grid['local_bytes']} local bytes, "
          f"{grid['registers']} registers, {grid['blocks_per_sm']} blocks an SM")
    check_tensor_core_grid("gram_sym_acc", r["grid"]["bf16"], tiles)
    # bf16 F: the Gramian of gram_corr_sym_acc's bf16 form, bit for bit (one
    # tensor-core mainloop), F read in place.
    staged = dict(cuda_ops.staged)
    R = torch.randn((n, AMAZON_K), generator=gen, device=dev)
    C0 = torch.zeros((d, AMAZON_K), device=dev)
    link = torch.equal(cuda_ops.gram_sym_acc(G0, F16)[upper],
                       cuda_ops.gram_corr_sym_acc(G0, C0, F16, R)[0][upper])
    check("gram_sym_acc bf16 has the bits of gram_corr_sym_acc's Gramian, reading F in place",
          link and cuda_ops.staged == staged,
          f"bitwise equal {link}, staged copies {cuda_ops.staged} (before {staged})")
    del F, F16, G, G0, upper, R, C0
    torch.cuda.empty_cache()
    f64 = r["bf16_vs_f64"] = gram_f64_reading(cuda_ops, gen)
    check(f"gram_sym_acc bf16 F {N_TRAIN}x{d} within {ROW7_F64_TOL:.0e} of float64 sums",
          f64["kernel"] <= ROW7_F64_TOL,
          f"{f64['kernel']:.3e} of the sums' scale (the parent build's FMA kernel read "
          f"{ROW7_F64_PARENT}; bf16 gram_corr_sym_acc 1.4e-5)")
    return results


def tma_slab(F):
    """F in bf16 at a row stride rounded up to 64 elements: the layout of
    the sparse fold's bf16 slabs, which the kernel's TMA loads read in
    place."""
    n, d = F.shape
    out = torch.zeros((n, -(-d // 64) * 64), dtype=torch.bfloat16, device=F.device)[:, :d]
    return out.copy_(F)


def f32_slab(F):
    """F at a row stride rounded up to 4 elements: the layout of the sparse
    fold's float32 slabs, which the kernel copies in 16-byte chunks."""
    n, d = F.shape
    return torch.zeros((n, -(-d // 4) * 4), device=F.device)[:, :d].copy_(F)


def acc_f64_reading(cuda_ops, F16, F32, R, G0, C0, upper):
    """How far the sparse fold's step is from float64 sums on one Amazon
    chunk, as max |got - f64| / max |f64| over the upper tiles (G) and
    over C: the bf16 form (TMA + ``wgmma``, the tensor cores' adds) against
    ``G0 + F16ᵀF16`` with R rounded to bf16, beside the same products by
    ``addmm`` with bf16 operands and float32 output; the float32 form
    (``gram_tile.cuh``'s row chunks) against ``G0 + FᵀF`` beside two float32
    ``addmm``. The float64 sums are made on the card in 8,192-row chunks."""
    R16 = R.to(torch.bfloat16)
    out = {}
    for label, Fs, Rs in (("bf16", F16, R16), ("f32", F32, R)):
        g64, c64 = G0.double(), C0.double()
        for start in range(0, Fs.shape[0], 8192):
            Fc = Fs[start:start + 8192].double()
            g64.addmm_(Fc.T, Fc)
            c64.addmm_(Fc.T, Rs[start:start + 8192].double())
        del Fc
        g_max, c_max = g64[upper].abs().max(), c64.abs().max()

        def rel(got, want_max=g_max, g64=g64, c64=c64):
            g, c = got
            return ((g.double() - g64)[upper].abs().max() / want_max).item(), (
                (c.double() - c64).abs().max() / c_max).item()

        kernel = rel(cuda_ops.gram_corr_sym_acc(G0, C0, Fs, R))
        if label == "bf16":
            library = rel((bf16_mm(F16.T, F16, G0), bf16_mm(F16.T, R16, C0)))
        else:
            library = rel((torch.addmm(G0, F32.T, F32), torch.addmm(C0, F32.T, R)))
        out[label] = dict(kernel_gram=kernel[0], kernel_corr=kernel[1],
                          library_gram=library[0], library_corr=library[1])
        log(f"  gram_corr_sym_acc {label} F against float64 sums (max |err| / max |f64|): "
            f"kernel G {kernel[0]:.3e}, C {kernel[1]:.3e}; library (addmm) G "
            f"{library[0]:.3e}, C {library[1]:.3e}")
        del g64, c64
    check("gram_corr_sym_acc is finite against float64 sums",
          all(np.isfinite(v) for row in out.values() for v in row.values()), f"{out}")
    return out


def tensor_core_line(grid):
    """How a Gramian-alone grid reads F: on the tensor cores (TMA, in place
    or staged first) or on the FP32 tile (16-byte or element-wise copies)."""
    if grid["tensor_cores"]:
        return "tensor cores, TMA " + ("from a staged copy" if grid["staged"] else "in place")
    return "FP32 tile, " + ("16-byte" if grid["vec"] else "element-wise") + " copies"


def check_tensor_core_grid(name, grid, tiles):
    """A bf16 Gramian-alone grid: the tensor-core kernel, one block an upper
    tile, F read in place, no spills, one block an SM."""
    check(f"{name} bf16 runs on the tensor cores, reads F in place, computes the upper tiles "
          f"only at one block an SM and spills nothing",
          grid["tensor_cores"] and not grid["staged"] and grid["blocks"] == tiles
          and grid["blocks_per_sm"] == 1 and grid["local_bytes"] == 0,
          f"{grid['blocks']} blocks, {grid['blocks_per_sm']} an SM, {grid['registers']} "
          f"registers, {grid['local_bytes']} local bytes, staged {grid['staged']}")


def gram_f64_reading(cuda_ops, gen):
    """How far bf16 ``gram_sym_acc`` is from float64 sums at the reference
    bench's streamed tile, F 65,536 x 16,384 (a random G0), as max |got -
    f64| / max |f64| over the upper tiles, as ``acc_f64_reading`` reads
    ``gram_corr_sym_acc``; beside ``addmm`` with bf16 operands and float32
    output. The float64 sums are made on the card in 8,192-row chunks."""
    dev = torch.device("cuda")
    n, d = N_TRAIN, D_FEAT
    F16 = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    G0 = torch.randn((d, d), generator=gen, device=dev)
    tiles = torch.arange(d, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    g64 = G0.double()
    for start in range(0, n, 8192):
        Fc = F16[start:start + 8192].double()
        g64.addmm_(Fc.T, Fc)
    del Fc
    g_max = g64[upper].abs().max()
    out = {}
    for label, got in (("kernel", lambda: cuda_ops.gram_sym_acc(G0, F16)),
                       ("library", lambda: bf16_mm(F16.T, F16, G0))):
        g = got()
        out[label] = ((g.double() - g64)[upper].abs().max() / g_max).item()
        del g
    log(f"  gram_sym_acc bf16 F {n}x{d} against float64 sums (max |err| / max |f64|): kernel "
        f"{out['kernel']:.3e}, library (addmm) {out['library']:.3e}")
    del F16, G0, upper, g64
    torch.cuda.empty_cache()
    return out


def lcg_uniform(rows, cols, salt, device):
    """A (rows, cols) float32 matrix of values in [-2, 2) from integer
    arithmetic on each element's index (a Lehmer step, an xor-shift, a
    second step), so its bits depend on no random number generator of the
    PyTorch build: a fixed input whose outputs can be compared by hash
    across builds of a kernel."""
    p = 2147483647
    out = torch.empty((rows, cols), device=device)
    step = max(1, (1 << 26) // cols)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        h = (torch.arange(r0 * cols, r1 * cols, dtype=torch.int64, device=device) * 48271
             + salt) % p
        h = ((h ^ (h >> 13)) * 48271) % p
        out[r0:r1] = (h.to(torch.float32) * (4.0 / p) - 2.0).view(r1 - r0, cols)
    return out


def row8_bits(cuda_ops):
    """SHA-256 of bf16 ``gram_corr_sym_acc``'s output, (G's upper tiles, C)
    in place, on a fixed Amazon chunk (``lcg_uniform`` F 65,536 x 16,385 at
    the fold's row stride, R 65,536 x 2, G0 and C0): the bits a build of the
    kernel gives, compared across builds."""
    import hashlib

    dev = torch.device("cuda")
    c, d1, k = AMAZON_CHUNK, AMAZON_D + 1, AMAZON_K
    F = tma_slab(lcg_uniform(c, d1, 1, dev))
    R = lcg_uniform(c, k, 2, dev)
    G = lcg_uniform(d1, d1, 3, dev)
    C = lcg_uniform(d1, k, 4, dev)
    cuda_ops.gram_corr_sym_acc(G, C, F, R, out=(G, C))
    tiles = torch.arange(d1, device=dev) // 128
    digest = hashlib.sha256(G[tiles[:, None] <= tiles[None, :]].cpu().numpy().tobytes())
    digest.update(C.cpu().numpy().tobytes())
    del F, R, G, C, tiles
    torch.cuda.empty_cache()
    return digest.hexdigest()


def phase_gram_corr_sym_acc(cuda_ops, gen):
    """The sparse fold's kernel on one Amazon chunk: F 65,536 x 16,385 (d
    and the intercept lane), R 65,536 x 2, a random G0 and C0; F in f32
    (at the fold's row stride of 16,388, and at 16,385, which the kernel
    copies element by element: the same bits) and bf16 (at the fold's row
    stride of 16,448), and the ragged last chunk of 41,248 rows; in place
    and into a new buffer. F is dense standard normal, so every product is
    nonzero (a densified chunk has 83 nonzeros a row; the kernel's time
    does not depend on it). The JSON line reports the bf16 numbers (TMA +
    wgmma): the bench's engine folds bf16 slabs; and the f32 kernel's
    (FP32 FMA, the Gramian kernel of gram_tile.cuh) beside two float32
    addmm, ``f32_*``."""
    dev = torch.device("cuda")
    c, d1, k = AMAZON_CHUNK, AMAZON_D + 1, AMAZON_K
    F = torch.randn((c, d1), generator=gen, device=dev)
    F32 = f32_slab(F)
    F16 = tma_slab(F)
    R = torch.randn((c, k), generator=gen, device=dev)
    G0 = torch.randn((d1, d1), generator=gen, device=dev)
    C0 = torch.randn((d1, k), generator=gen, device=dev)
    tiles = torch.arange(d1, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    results, f32_first = {}, None
    for label, Fs, rows in (("f32 at the fold's row stride", F32, c),
                            ("f32 at row stride 16,385", F, c),
                            ("f32 ragged chunk", F32, AMAZON_RAGGED),
                            ("bf16", F16, c), ("bf16 ragged chunk", F16, AMAZON_RAGGED)):
        dtype = Fs.dtype
        Fk, Rk = Fs[:rows], R[:rows]
        want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G0, C0, Fk, Rk)
        Ff = Fk.float()
        Rq = Rk.to(torch.bfloat16).float() if dtype == torch.bfloat16 else Rk
        # Errors relative to the scale of the sums, |G0| + sum |f_i||f_j| and
        # |C0| + sum |f||r|: two f32 sums of 65,536 terms in different orders
        # differ by about sqrt(rows) * 2^-24 of it.
        g_scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
        c_scale = torch.addmm(C0.abs(), Ff.abs().T, Rq.abs())
        del Ff
        fresh = cuda_ops.gram_corr_sym_acc(G0, C0, Fk, Rk)
        G, C = G0.clone(), C0.clone()
        cuda_ops.gram_corr_sym_acc(G, C, Fk, Rk, out=(G, C))
        torch.cuda.synchronize()
        g_diff = (fresh[0] - want_g).abs()
        g_err = g_diff[upper].max().item()
        g_rel = (g_diff.div_(g_scale))[upper].max().item()
        c_diff = (fresh[1] - want_c).abs()
        c_err, c_rel = c_diff.max().item(), (c_diff / c_scale).max().item()
        same = (torch.equal(G[upper], fresh[0][upper]) and torch.equal(C, fresh[1])
                and torch.equal(G[~upper], G0[~upper]))
        if dtype == torch.float32 and rows == c:  # both f32 layouts: the same bits
            f32_first = f32_first or (G, C)
            same = (same and torch.equal(G[upper], f32_first[0][upper])
                    and torch.equal(C, f32_first[1]))
        check(f"gram_corr_sym_acc {label} F {rows}x{d1}, R {rows}x{k}",
              g_rel <= 1e-4 and c_rel <= 1e-4 and same,
              f"upper tiles max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr "
              f"max_abs_err {c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale; in place "
              f"the bits of a new buffer, lower tiles untouched"
              + ("; the f32 layouts' bits equal" if dtype == torch.float32 and rows == c
                 else ""))
        if label == "bf16":
            results["gram_corr_sym_acc"] = dict(max_abs_err=max(g_err, c_err))
        if label.startswith("f32 at the fold"):
            f32_err = max(g_err, c_err)
        del Fk, want_g, want_c, g_scale, c_scale, fresh, G, C, g_diff, c_diff
    f64 = acc_f64_reading(cuda_ops, F16, F32, R, G0, C0, upper)
    del upper, f32_first
    torch.cuda.empty_cache()
    flops = c * d1 * (d1 + 1) + 2 * c * d1 * k  # upper triangle (syrk) + correlation
    G, C = G0.clone(), C0.clone()
    R16 = R.to(torch.bfloat16)
    r = results["gram_corr_sym_acc"]
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_acc(G, C, F16, R, out=(G, C)), 3)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_acc_ref(G0, C0, F16, R), 3)
    # One addmm for G and one for C in the operand dtype: bf16 on the
    # tensor cores, accumulating and returning float32.
    r["library_ms"] = time_ms(lambda: (
        torch.addmm(G0, F16.T, F16, out_dtype=torch.float32),
        torch.addmm(C0, F16.T, R16, out_dtype=torch.float32),
    ), 3)
    r["bound_ms"], r["bound_by"] = bound_ms(
        2 * c * d1 + 4 * (c * k + 2 * d1 * d1 + 2 * d1 * k), flops, PEAK_BF16_FLOPS)
    f32_ms = time_ms(lambda: cuda_ops.gram_corr_sym_acc(G, C, F32, R, out=(G, C)), 3)
    f32_unaligned_ms = time_ms(lambda: cuda_ops.gram_corr_sym_acc(G, C, F, R, out=(G, C)), 2)
    # The same two products in float32 on cuBLAS (no TF32: the package sets
    # float32 matmuls to "highest" when it is imported).
    f32_library_ms = time_ms(lambda: (torch.addmm(G0, F.T, F), torch.addmm(C0, F.T, R)), 2)
    f32_plain_ms = time_ms(lambda: cuda_ops.gram_corr_sym_acc_ref(G0, C0, F32, R), 2)
    f32_bound, f32_bound_by = bound_ms(4 * (c * d1 + c * k + 2 * d1 * d1 + 2 * d1 * k), flops,
                                       PEAK_F32_FLOPS)
    r.update(f32_ms=f32_ms, f32_unaligned_ms=f32_unaligned_ms, f32_plain_ms=f32_plain_ms,
             f32_library_ms=f32_library_ms, f32_bound_ms=f32_bound, f32_bound_by=f32_bound_by,
             f32_max_abs_err=f32_err, f32_grid={}, vs_f64=f64)
    log(f"  gram_corr_sym_acc bf16 F {c}x{d1} (row stride {F16.stride(0)}), R {c}x{k}: "
        f"{r['ms']:.3f} ms, {flops / r['ms'] / 1e9:.1f} TFLOP/s (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"f32 F (row stride {F32.stride(0)}): {f32_ms:.3f} ms (at row stride {F.stride(0)} "
        f"{f32_unaligned_ms:.3f}; plain {f32_plain_ms:.3f}, library {f32_library_ms:.3f}, "
        f"FP32 bound {f32_bound:.3f} by {f32_bound_by})")
    for label, Fk in (("fold's row stride", F32), ("row stride 16,385", F)):
        grid = r["f32_grid"][label] = cuda_ops.gram_corr_sym_acc_grid(Fk, k)
        log(f"  gram_corr_sym_acc f32 F at the {label} grid: {grid['corr_blocks']} "
            f"correlation blocks ({grid['ktile']}-wide label tile), then {grid['gram_blocks']} "
            f"Gramian tiles ({'16-byte' if grid['vec'] else 'element-wise'} copies): "
            f"{grid_line(grid)}")
    r["bf16_sha256"] = row8_bits(cuda_ops)
    check("gram_corr_sym_acc bf16 keeps the bits it had before its mainloop moved to "
          "gram_wgmma.cuh", r["bf16_sha256"] == ROW8_BF16_SHA256,
          f"SHA-256 of its output on the fixed Amazon chunk {r['bf16_sha256']} (the parent "
          f"build's {ROW8_BF16_SHA256})")
    grid = r["f32_grid"]["fold's row stride"]
    nt = -(-d1 // 128)
    check("gram_corr_sym_acc f32 computes the upper tiles only, copies the fold's slab in "
          "16-byte chunks, spills nothing and holds 2 blocks an SM at <= 128 registers",
          grid["gram_blocks"] == nt * (nt + 1) // 2 and grid["vec"]
          and grid["local_bytes"] == 0 and grid["blocks_per_sm"] >= 2
          and grid["registers"] <= 128,
          f"{grid['gram_blocks']} Gramian blocks, {grid['local_bytes']} local bytes, "
          f"{grid['registers']} registers, {grid['blocks_per_sm']} blocks an SM")
    del F, F32, R, F16, R16, G0, C0, G, C
    torch.cuda.empty_cache()
    return results


def phase_small_reference(timit, TimitConfig):
    """The three routes at a small size on the card (kernels) and on the
    CPU (plain versions), same data and weights: errors must agree."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import PipelineEnv

    for solver, fit_first, route in (("block", True, FLAT), ("block", False, STACKED),
                                     ("streaming", True, STREAMED)):
        config = TimitConfig(solver=solver, num_cosines=2, block_size=256, synthetic_n=2048,
                             num_epochs=2)
        runs = {}
        for device in ("cuda", "cpu"):
            PipelineEnv.get_or_create().reset()
            models = [
                CosineRandomFeatures(D_IN, config.block_size, config.gamma,
                                     seed=config.seed + i, device=device)
                for i in range(config.num_cosines)
            ]
            runs[device] = timit.run(config, device=device, cosine_models=models,
                                     fit_first=fit_first)
        PipelineEnv.get_or_create().reset()
        errs = {dev: (r.train_eval.total_error, r.test_eval.total_error)
                for dev, r in runs.items()}
        same = all(abs(a - b) <= 0.005 for a, b in zip(errs["cuda"], errs["cpu"]))
        check(f"small {route}, card against CPU plain versions", same,
              f"train/test error cuda {errs['cuda']}, cpu {errs['cpu']} (within 0.5 points)")


def check_metrics(what, train_eval, test_eval, n_train):
    train_err, test_err = train_eval.total_error, test_eval.total_error
    check(f"{what} metrics", all(0.0 <= e <= 1.0 for e in (train_err, test_err))
          and test_err < 0.5 and train_eval.total == n_train
          and test_eval.total == n_train // 4,
          f"errors in [0, 1], test error below 50% (chance is {100 * (K - 1) / K:.1f}%), "
          f"every row scored")


def phase_timit_route(cuda_ops, timit, TimitConfig, fit_first):
    """One TIMIT route at full width, launches counted from 0."""
    from keystone_tpu_torch.workflow import PipelineEnv

    route = FLAT if fit_first else STACKED
    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="block", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=N_TRAIN, num_epochs=EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = timit.run(config, device="cuda", fit_first=fit_first)
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    fit_what = "fit" if fit_first else "fit + train apply"
    apply_what = "apply (train + test)" if fit_first else "test apply"
    log(f"  {route}, n={N_TRAIN}, d={D_FEAT}, k={K}, block {BLOCK}, {EPOCHS} epochs: "
        f"train error {100 * train_err:.3f}%, test error {100 * test_err:.3f}%, "
        f"{fit_what} {result.fit_seconds:.3f} s, {apply_what} {result.apply_seconds:.3f} s, "
        f"run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    if fit_first:
        check(f"{route} launches", same_launches(counts, FLAT_LAUNCHES),
              f"{counts}, expected {FLAT_LAUNCHES}")
    else:
        ok = counts["gram_corr_sym"] > 0 and counts["cosine_features"] > 0
        check(f"{route} launches", ok, f"gram_corr_sym {counts['gram_corr_sym']}, "
              f"cosine_features {counts['cosine_features']}, both > 0")
    check_metrics(route, result.train_eval, result.test_eval, N_TRAIN)
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err,
                        test_error=test_err), block_model(result.fitted)


def block_mapper(fitted):
    """A fitted pipeline's one BlockLinearMapper, stand-alone or inside the
    solver selector's chain."""
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

    (mapper,) = [getattr(op, "model", op) for op in fitted.transformer_graph.operators.values()
                 if isinstance(getattr(op, "model", op), BlockLinearMapper)]
    return mapper


def block_weights(fitted):
    """The (d, k) weights of a fitted pipeline's one BlockLinearMapper."""
    return torch.cat(block_mapper(fitted).xs)


def block_model(fitted):
    """(weights (d, k), affine offset (k,)) of a fitted pipeline's one
    centred BlockLinearMapper: predictions are F W + offset, offset =
    b_opt − mean W."""
    mapper = block_mapper(fitted)
    W = torch.cat(mapper.xs)
    mean = torch.cat([s.mean for s in mapper.feature_scalers])
    return W, mapper.b_opt - mean @ W


def phase_quickstart(cuda_ops):
    """The README quick-start composition on the slice's rows."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    train = synthetic_timit(N_TRAIN, seed=123, device="cuda")
    test = synthetic_timit(N_TRAIN // 4, seed=124, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline = (
        CosineRandomFeatures(D_IN, QS_WIDTH, gamma=0.05, seed=7, device="cuda")
        .and_then(BlockLeastSquaresEstimator(block_size=QS_BLOCK, num_iter=3, lam=1e-4),
                  train.data, labels)
        .and_then(MaxClassifier())
    )
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_pred, test_pred = fitted.apply(train.data), fitted.apply(test.data)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    evaluator = MulticlassClassifierEvaluator(K)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    PipelineEnv.get_or_create().reset()
    log(f"  quick start, n={N_TRAIN}, 440 -> {QS_WIDTH} cosines, block {QS_BLOCK}, 3 iterations: "
        f"train error {100 * train_eval.total_error:.3f}%, test error "
        f"{100 * test_eval.total_error:.3f}%, fit {fit_s:.3f} s, apply {apply_s:.3f} s, "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts}")
    check("quick start went through the fused fit",
          all(counts[name] > 0 for name in ("block_gram_sym", "block_corr",
                                            "block_residual_update", "cosine_features"))
          and counts["gram_corr_sym"] == 0, f"launches {counts}")
    check_metrics("quick start", train_eval, test_eval, N_TRAIN)


def phase_streamed(cuda_ops, timit, TimitConfig):
    """--solver streaming at full width on 275,000 rows, launches counted
    from 0."""
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="streaming", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=STREAM_N, num_epochs=EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = timit.run(config, device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    log(f"  {STREAMED}, n={STREAM_N}, d={D_FEAT}, k={K}, block {BLOCK}, tile {STREAM_TILE}, "
        f"{EPOCHS} epochs: train error {100 * train_err:.3f}%, test error "
        f"{100 * test_err:.3f}%, fit {result.fit_seconds:.3f} s, apply (train + test) "
        f"{result.apply_seconds:.3f} s, run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    check(f"{STREAMED} launches", same_launches(counts, STREAMED_LAUNCHES),
          f"{counts}, expected {STREAMED_LAUNCHES}")
    check_metrics(STREAMED, result.train_eval, result.test_eval, STREAM_N)
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err, test_error=test_err)


def phase_optimizer_bound(cuda_ops, timit, TimitConfig):
    """The TIMIT featurizer composed with StreamingLeastSquaresChoice: the
    optimizer binds the featurizer into a streamed fit. Held against
    --solver streaming on the same rows and draws."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.streaming_ls import (
        StreamingFeaturizedLinearModel,
        StreamingLeastSquaresChoice,
    )
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import DefaultOptimizer, PipelineEnv

    config = TimitConfig(solver="streaming", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=N_TRAIN, num_epochs=EPOCHS)
    PipelineEnv.get_or_create().reset()
    flag = timit.run(config, device="cuda")
    PipelineEnv.get_or_create().reset()
    train = synthetic_timit(N_TRAIN, seed=config.seed, device="cuda")
    test = synthetic_timit(N_TRAIN // 4, seed=config.seed + 1, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    pipeline = timit.build_featurizer(config, "cuda").and_then(
        StreamingLeastSquaresChoice(num_iter=EPOCHS, lam=0.0, block_size_hint=BLOCK),
        train.data, labels,
    ).and_then(MaxClassifier())
    plan, _ = DefaultOptimizer().execute(pipeline.executor.graph, {})
    streamed = [op.label for op in plan.operators.values() if op.label.startswith("StreamedFit[")]
    check("optimizer binds the featurizer into a streamed fit", len(streamed) == 1,
          f"plan labels {sorted(op.label for op in plan.operators.values())}")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_pred, test_pred = fitted.apply(train.data), fitted.apply(test.data)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    evaluator = MulticlassClassifierEvaluator(K)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    PipelineEnv.get_or_create().reset()
    errs = (train_eval.total_error, test_eval.total_error)
    flag_errs = (flag.train_eval.total_error, flag.test_eval.total_error)
    log(f"  optimizer-bound streamed fit ({streamed[0]}), n={N_TRAIN}: train error "
        f"{100 * errs[0]:.3f}%, test error {100 * errs[1]:.3f}%, fit {fit_s:.3f} s, apply "
        f"{apply_s:.3f} s, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {counts}; --solver streaming on the same rows: fit "
        f"{flag.fit_seconds:.3f} s, errors {flag_errs}")
    tiles = -(-N_TRAIN // STREAM_TILE)
    check("optimizer-bound fit went through the streamed fold",
          counts["gram_sym_acc"] == tiles and counts["cosine_features"] > 0
          and all(counts[name] == 0 for name in ("gram_corr_sym", "block_gram_sym",
                                                 "block_corr", "block_residual_update")),
          f"launches {counts}: gram_sym_acc {tiles}, cosine_features > 0, the others 0")
    check("optimizer-bound errors match --solver streaming",
          all(abs(a - b) <= 0.005 for a, b in zip(errs, flag_errs)),
          f"{errs} against {flag_errs} (within 0.5 points)")
    # The two routes fold the same bank over the same rows in the same
    # tiles: the fitted models agree to rounding.
    (got,), (want,) = (
        [op for op in f.transformer_graph.operators.values()
         if isinstance(op, StreamingFeaturizedLinearModel)]
        for f in (fitted, flag.fitted)
    )
    rel = {
        name: float((getattr(got, name) - getattr(want, name)).norm()
                    / getattr(want, name).norm())
        for name in ("W_stack", "fmean", "ymean")
    }
    log(f"  optimizer-bound model against --solver streaming, relative Frobenius: {rel}")
    check("optimizer-bound model matches --solver streaming",
          all(v <= 1e-4 for v in rel.values()), f"{rel} (each within 1e-4)")
    check_metrics("optimizer-bound streamed fit", train_eval, test_eval, N_TRAIN)


def log_decision(decision):
    """The selector's budget and every candidate it priced."""
    ctx = decision["context"]
    log(f"  selector: n={ctx['n']}, d={ctx['d']}, k={ctx['k']}, sparsity {ctx['sparsity']}, "
        f"device budget {ctx['hbm_budget_bytes'] / 2**30:.3f} GiB, host budget "
        f"{ctx['host_budget_bytes'] / 2**30:.3f} GiB, weights {ctx['weights']}")
    for c in decision["candidates"]:
        cost = "inf" if c["cost_s"] is None else f"{c['cost_s']:.6g}"
        log(f"    {c['label']}: cost {cost}, resident {c['resident_bytes'] / 2**30:.3f} GiB "
            f"({c['resident_bytes'] / ctx['hbm_budget_bytes']:.3f} of the budget), "
            f"feasible {c['feasible']}")
    log(f"  selector winner {decision['winner']} ({decision['reason']})")


def run_auto(cuda_ops, timit, TimitConfig, n, num_cosines=NUM_COSINES):
    """TIMIT --solver auto on n training rows and num_cosines branches
    through its entry point, on the card's own budget; launches counted
    from 0. The selector's wall is the NodeOptimizationRule's: sampling the
    featurized rows and pricing the candidates."""
    from keystone_tpu_torch.workflow import PipelineEnv, rules

    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="auto", num_cosines=num_cosines, block_size=BLOCK,
                         synthetic_n=n, num_epochs=EPOCHS, lam=0.0)
    walls = []
    select = rules.NodeOptimizationRule.apply

    def timed_select(self, plan, prefixes):
        t0 = time.perf_counter()
        out = select(self, plan, prefixes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    cuda_ops.reset_launch_counts()
    rules.NodeOptimizationRule.apply = timed_select
    try:
        t0 = time.perf_counter()
        result = timit.run(config, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        rules.NodeOptimizationRule.apply = select
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    decision = result.selector.last_decision
    log_decision(decision)
    stats = dict(n=n, winner=decision["winner"], reason=decision["reason"],
                 fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                 selector_seconds=sum(walls), peak_allocated_bytes=peak,
                 baseline_allocated_bytes=baseline,
                 train_error=result.train_eval.total_error,
                 test_error=result.test_eval.total_error, launches=counts)
    log(f"  n={n}: train error {100 * stats['train_error']:.3f}%, test error "
        f"{100 * stats['test_error']:.3f}%, fit {result.fit_seconds:.3f} s, apply (train + "
        f"test) {result.apply_seconds:.3f} s, selector (sampling and pricing) "
        f"{stats['selector_seconds']:.3f} s in {len(walls)} call(s), run {wall:.3f} s (data "
        f"generation included), peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    return result, stats


def phase_auto(cuda_ops, timit, TimitConfig, stacked_W):
    """--solver auto on both sides of the memory wall: the block chain at
    N_TRAIN rows (held against --solver block's apply-first weights on the
    same rows and draws), the streamed fit at AUTO_WALL_N rows (every
    resident candidate over the budget by more than 5%)."""
    from keystone_tpu_torch.ops.learning.streaming_ls import StreamingFeaturizedLinearModel
    from keystone_tpu_torch.workflow import PipelineEnv

    log(f"  (a) resident, n={N_TRAIN}")
    result, resident = run_auto(cuda_ops, timit, TimitConfig, N_TRAIN)
    res_counts = resident["launches"]
    ops = list(result.fitted.transformer_graph.operators.values())
    check(f"{AUTO_RESIDENT}: the selector picks the block chain",
          resident["winner"] == "BlockLeastSquaresEstimator"
          and any(type(op).__name__ == "Chained" for op in ops),
          f"winner {resident['winner']}, fitted {[type(op).__name__ for op in ops]}")
    W = block_weights(result.fitted)
    rel = float((W - stacked_W).norm() / stacked_W.norm())
    resident["weights_rel_to_block_stacked"] = rel
    check(f"{AUTO_RESIDENT}: weights match --solver block apply-first", rel <= 1e-5,
          f"relative Frobenius {rel:.3g} (within 1e-5: the same stacked solver on the "
          f"same features)")
    check(f"{AUTO_RESIDENT} launches",
          res_counts["gram_corr_sym"] > 0 and res_counts["cosine_features"] > 0
          and all(res_counts[name] == 0 for name in ("block_gram_sym", "block_corr",
                                                     "block_residual_update", "gram_sym_acc")),
          f"gram_corr_sym and cosine_features > 0, the flat and streamed kernels 0")
    check_metrics(AUTO_RESIDENT, result.train_eval, result.test_eval, N_TRAIN)
    del result
    torch.cuda.empty_cache()

    log(f"  (b) past the wall, n={AUTO_WALL_N}")
    result, walled = run_auto(cuda_ops, timit, TimitConfig, AUTO_WALL_N)
    wall_counts = walled["launches"]
    models = [op for op in result.fitted.transformer_graph.operators.values()
              if isinstance(op, StreamingFeaturizedLinearModel)]
    check(f"{AUTO_WALL}: the selector picks the streaming choice and the fit is streamed",
          walled["winner"] == "StreamingLeastSquaresChoice" and len(models) == 1,
          f"winner {walled['winner']}, streamed models {len(models)}")
    decision = result.selector.last_decision
    budget = decision["context"]["hbm_budget_bytes"]
    over = {c["label"]: c["resident_bytes"] / budget for c in decision["candidates"]
            if c["label"] != "StreamingLeastSquaresChoice"}
    walled["resident_over_budget"] = over
    check(f"{AUTO_WALL}: every resident candidate over the budget by more than 5%",
          all(v > 1.05 for v in over.values()), f"resident / budget {over}")
    check(f"{AUTO_WALL} launches",
          wall_counts["gram_sym_acc"] == AUTO_WALL_TILES
          and wall_counts["cosine_features"] == AUTO_WALL_COSINES
          and all(wall_counts[name] == 0 for name in ("gram_corr_sym", "block_gram_sym",
                                                      "block_corr", "block_residual_update")),
          f"gram_sym_acc {wall_counts['gram_sym_acc']} (expected {AUTO_WALL_TILES}, one a "
          f"tile, all in the fit), cosine_features {wall_counts['cosine_features']} (expected "
          f"{AUTO_WALL_COSINES}), the resident solvers' kernels 0")
    check_metrics(AUTO_WALL, result.train_eval, result.test_eval, AUTO_WALL_N)
    # The synthetic rows are separable at this n, so the errors alone would
    # pass a wrong fit: hold the model against --solver streaming's on the
    # same rows and draws. Both fold the same bank over the same 32,768-row
    # tiles, so they agree to rounding.
    names = ("W_stack", "fmean", "ymean")
    got = {name: getattr(models[0], name).clone() for name in names}
    del result, models
    torch.cuda.empty_cache()
    PipelineEnv.get_or_create().reset()
    flag = timit.run(TimitConfig(solver="streaming", num_cosines=NUM_COSINES, block_size=BLOCK,
                                 synthetic_n=AUTO_WALL_N, num_epochs=EPOCHS, lam=0.0),
                     device="cuda")
    PipelineEnv.get_or_create().reset()
    (want,) = [op for op in flag.fitted.transformer_graph.operators.values()
               if isinstance(op, StreamingFeaturizedLinearModel)]
    rel = {name: float((got[name] - getattr(want, name)).norm() / getattr(want, name).norm())
           for name in names}
    walled["model_rel_to_solver_streaming"] = rel
    log(f"  auto's streamed model against --solver streaming at n={AUTO_WALL_N} (fit "
        f"{flag.fit_seconds:.3f} s), relative Frobenius: {rel}")
    check(f"{AUTO_WALL}: model matches --solver streaming", all(v <= 1e-5 for v in rel.values()),
          f"{rel} (each within 1e-5: the same streamed solver, tiles and draws)")
    walled["solver_streaming_fit_seconds"] = flag.fit_seconds
    f32_model = {name: getattr(want, name) for name in names}
    del flag, want
    torch.cuda.empty_cache()
    return resident, walled, f32_model


def _rel_to(got, want):
    """Relative Frobenius distance of each named tensor from ``want``'s."""
    return {name: _rel(got[name], w) for name, w in want.items()}


def bf16_route_fits(cuda_ops):
    """The bf16 Gramians' two routes at TIMIT's width, launches counted from
    0 over each fit: (i) the gram-tier streamed fit,
    ``StreamingFeaturizedLeastSquares`` over a
    ``CosineBankFeaturize(feat_dtype=torch.bfloat16)`` (440 -> 16,384, 147
    classes) on AUTO_WALL_N rows in tiles of a 2 GiB bf16 slab, the draws
    and rows of phase 11(b)'s --solver streaming fit; (ii) the flat fused
    fit ``bcd_least_squares_fused_flat`` on a bf16 N_TRAIN x D_FEAT slab
    (phase 2's rows through the same bank, centred, rounded to bf16),
    blocks of BLOCK, and the same fit on the float32 slab. Returns each
    fit's seconds, launches, staged copies and weights."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.ops.learning.streaming_ls import (
        CosineBankFeaturize, StreamingFeaturizedLeastSquares)
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.workflow.fusion import masked_center

    dev = torch.device("cuda")
    rfs = timit._cosine_models(timit.TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK), dev)
    Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
    staged = getattr(cuda_ops, "staged", {})  # a build before the tensor-core form has none

    def timed(fit):
        torch.cuda.synchronize()
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        return out, dict(fit_seconds=time.perf_counter() - t0, launches=dict(cuda_ops.launches),
                         staged=dict(staged))

    train = synthetic_timit(AUTO_WALL_N, seed=123, device=dev)
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    est = StreamingFeaturizedLeastSquares(
        CosineBankFeaturize(Wrf, brf, torch.bfloat16), d_feat=D_FEAT, block_size=BLOCK,
        num_iter=EPOCHS, lam=0.0)
    model, streamed = timed(lambda: est.fit(train.data, labels))
    streamed.update(n=AUTO_WALL_N, tile_rows=est.tile_rows,
                    model={name: getattr(model, name) for name in ("W_stack", "fmean", "ymean")})
    del train, labels, est, model
    torch.cuda.empty_cache()

    train = synthetic_timit(N_TRAIN, seed=123, device=dev)
    Y = ClassLabelIndicatorsFromIntLabels(K)(train.labels).array
    F32 = CosineBankFeaturize(Wrf, brf)(train.data.array)
    F32, B, _, _ = masked_center(F32, Y, N_TRAIN)
    F16 = F32.to(torch.bfloat16)
    del train, Y
    W16, flat = timed(lambda: linalg.bcd_least_squares_fused_flat(
        F16, B, BLOCK, lam=0.0, num_iter=EPOCHS))
    W32, f32 = timed(lambda: linalg.bcd_least_squares_fused_flat(
        F32, B, BLOCK, lam=0.0, num_iter=EPOCHS))
    flat.update(n=N_TRAIN, d=D_FEAT, block=BLOCK, f32_fit_seconds=f32["fit_seconds"], W=W16,
                W32=W32)
    del F32, F16, B
    torch.cuda.empty_cache()
    return dict(streamed=streamed, flat=flat)


def phase_bf16_routes(cuda_ops, f32_model, f32_fit_seconds):
    """Phase 11(c): ``bf16_route_fits`` held to float32 fits on the same
    rows: the streamed fit to phase 11(b)'s --solver streaming model
    ``f32_model`` (fitted in ``f32_fit_seconds``), the flat fit to the
    float32 slab's. bf16 features differ from float32 ones by their
    rounding, so the weights agree to BF16_ROUTE_TOL, not to the float32
    routes' 1e-5. Neither route stages a copy of F."""
    out = bf16_route_fits(cuda_ops)
    streamed, flat = out["streamed"], out["flat"]
    rel = streamed["rel_to_f32"] = _rel_to(streamed.pop("model"), f32_model)
    streamed["f32_fit_seconds"] = f32_fit_seconds
    counts, staged, tiles = streamed["launches"], streamed["staged"], AUTO_WALL_N // BF16_TILE
    log(f"  (c) bf16 streamed fit, n={AUTO_WALL_N}, tiles of {streamed['tile_rows']}: fit "
        f"{streamed['fit_seconds']:.3f} s (float32 --solver streaming on the same rows, tiles "
        f"of {STREAM_TILE}: {f32_fit_seconds:.3f} s); relative Frobenius to it {rel}; "
        f"launches {counts}, staged {staged}")
    check("11(c) bf16 streamed fit: one gram_sym_acc and one cosine bank launch a 65,536-row "
          "tile, nothing staged",
          streamed["tile_rows"] == BF16_TILE
          and same_launches(counts, {"gram_sym_acc": tiles, "cosine_features": tiles})
          and not any(staged.values()),
          f"tile {streamed['tile_rows']}, {counts}, staged {staged}")
    check(f"11(c) bf16 streamed fit within {BF16_ROUTE_TOL} of the float32 fit",
          all(v <= BF16_ROUTE_TOL for v in rel.values()), f"{rel}")
    rel = flat["rel_to_f32"] = _rel_to({"W_stack": flat.pop("W")}, {"W_stack": flat.pop("W32")})
    counts, staged, blocks = flat["launches"], flat["staged"], D_FEAT // BLOCK
    want = {"block_gram_sym": blocks, "block_corr": EPOCHS * blocks,
            "block_residual_update": EPOCHS * blocks}
    log(f"  (c) bf16 flat fit, F {N_TRAIN}x{D_FEAT}, blocks of {BLOCK}: "
        f"{flat['fit_seconds']:.3f} s (the float32 slab {flat['f32_fit_seconds']:.3f} s); "
        f"relative Frobenius to it {rel}; launches {counts}, staged {staged}")
    check("11(c) bf16 flat fit: one block_gram_sym a block (the Gramians stashed after the "
          "first epoch), nothing staged",
          same_launches(counts, want) and not any(staged.values()),
          f"{counts}, expected {want}, staged {staged}")
    check(f"11(c) bf16 flat fit within {BF16_ROUTE_TOL} of the float32 fit",
          all(v <= BF16_ROUTE_TOL for v in rel.values()), f"{rel}")
    torch.cuda.empty_cache()
    return out


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def phase_block_small(cuda_ops):
    """Phase 12(a): the block-streamed program and its estimator small on the
    card against their plain runs on the CPU, on the same inputs: float32
    and bf16 features, centred and raw, ragged rows. Weights within 1e-4
    relative in float32 (reordered float32 sums); 5e-3 in bf16, where
    features that agree to float32 rounding round to bf16 values one step
    apart in ~0.02% of the entries and the program's weights move by about
    1e-3 from that alone, so bf16 weights cannot tell a program that
    makes float32 slabs (3.5e-3 to 4.0e-3 from bf16's): the CPU tests hold
    the slabs themselves (tests/test_torch_block_streamed.py)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.streaming_ls import (
        BlockStreamedLeastSquares,
        cosine_bank_featurize,
    )
    from keystone_tpu_torch.parallel import streaming

    rng = np.random.default_rng(12)
    n, n_true, d_in, d, bs = 4000, 3990, D_IN, 1024, 256
    X = torch.from_numpy((0.6 * rng.normal(size=(n, d_in))).astype(np.float32))
    labels = np.argmax(X.numpy() @ rng.normal(size=(d_in, K)), axis=1)
    Y = torch.from_numpy((2.0 * np.eye(K)[labels] - 1.0).astype(np.float32))
    Wrf = torch.from_numpy((np.sqrt(2 * 0.05555) * rng.normal(size=(d, d_in))).astype(np.float32))
    brf = torch.from_numpy(rng.uniform(0, 2 * np.pi, d).astype(np.float32))
    card = [t.to("cuda") for t in (X, Y, Wrf, brf)]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-3)):
        for center in (False, True):
            kw = dict(block_size=bs, lam=1e-3, num_iter=EPOCHS, n_true=n_true,
                      feat_dtype=dtype, center=center)
            want = streaming.streaming_block_bcd_mesh(X, Y, Wrf, brf, **kw)
            got = streaming.streaming_block_bcd_mesh(*card, **kw)
            want, got = (want, got) if center else ((want,), (got,))
            rels = [_rel(g.cpu(), w) for g, w in zip(got, want)]
            check(f"block program small, {str(dtype)[6:]} features, "
                  f"{'centred' if center else 'raw'}, card against CPU",
                  all(r <= tol for r in rels),
                  f"relative Frobenius {', '.join(f'{r:.2e}' for r in rels)} (W"
                  f"{', fmean, ymean' if center else ''}; tol {tol:.0e}), n {n_true} of {n}")
    est = lambda dev: BlockStreamedLeastSquares(  # noqa: E731
        cosine_bank_featurize(Wrf.to(dev), brf.to(dev)), d, bs, num_iter=EPOCHS, lam=1e-3)
    models = {dev: est(dev).fit(Dataset(X.to(dev), n=n_true), Dataset(Y.to(dev), n=n_true))
              for dev in ("cuda", "cpu")}
    preds = {dev: m.batch_apply(Dataset(X.to(dev))).array.cpu() for dev, m in models.items()}
    rels = [_rel(getattr(models["cuda"], name).cpu(), getattr(models["cpu"], name))
            for name in ("W_stack", "fmean", "ymean")] + [_rel(preds["cuda"], preds["cpu"])]
    check("BlockStreamedLeastSquares small, card against CPU", all(r <= 1e-4 for r in rels),
          f"W, fmean, ymean, predictions: {', '.join(f'{r:.2e}' for r in rels)} (tol 1e-4)")


def _errors(model, train, test):
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.util import MaxClassifier

    evaluator = MulticlassClassifierEvaluator(K)
    return tuple(
        evaluator.evaluate(MaxClassifier().batch_apply(model.batch_apply(rows.data)),
                           rows.labels).total_error
        for rows in (train, test))


def phase_block_resident(cuda_ops, timit, TimitConfig, stacked):
    """Phase 12(b): BlockStreamedLeastSquares on phase 2's rows and draws,
    held against phase 2's --solver block apply-first model (weights and
    affine offset within 1e-4 relative: the same centred Gauss-Seidel
    iterates at the same block size; only the centring's rounding differs,
    a rank-1 correction of the Gramian against explicitly centred
    features; the reference's own pair differs by 5.9e-7 on the CPU at
    8,192 rows and blocks of 512). Then the bf16 bank on the same rows."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.ops.learning.streaming_ls import (
        BlockStreamedLeastSquares,
        cosine_bank_featurize,
    )
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels

    config = TimitConfig(solver="block", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=N_TRAIN, num_epochs=EPOCHS)
    train = synthetic_timit(N_TRAIN, seed=config.seed, device="cuda")
    test = synthetic_timit(N_TRAIN // 4, seed=config.seed + 1, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    rfs = timit._cosine_models(config, "cuda")
    Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
    del rfs
    report = {}
    fitted = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        est = BlockStreamedLeastSquares(cosine_bank_featurize(Wrf, brf, dtype), D_FEAT, BLOCK,
                                        num_iter=EPOCHS, lam=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(train.data, labels)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        errs = _errors(model, train, test)
        fitted[label] = model
        report[label] = dict(fit_seconds=fit_s, train_error=errs[0], test_error=errs[1])
        log(f"  (b) {label} bank, n={N_TRAIN}, d={D_FEAT}, block {BLOCK}, {EPOCHS} epochs, "
            f"λ 0: fit {fit_s:.3f} s, train error {100 * errs[0]:.3f}%, test error "
            f"{100 * errs[1]:.3f}%")
    W_block, offset_block = stacked
    model = fitted["f32"]
    rel_W = _rel(model.W_stack.reshape(D_FEAT, K), W_block)
    rel_off = _rel(model.offset, offset_block)
    report["f32"].update(weights_rel_to_block=rel_W, offset_rel_to_block=rel_off)
    check(f"{BLOCK_RESIDENT}: model matches", rel_W <= 1e-4 and rel_off <= 1e-4,
          f"weights {rel_W:.2e}, affine offset {rel_off:.2e} relative Frobenius (tol 1e-4)")
    rel_bf16 = _rel(fitted["bf16"].W_stack, model.W_stack)
    report["bf16"]["weights_rel_to_f32"] = rel_bf16
    log(f"  (b) bf16 bank's weights against the f32 bank's: {rel_bf16:.3e} relative; errors "
        f"train {100 * report['bf16']['train_error']:.3f}% / test "
        f"{100 * report['bf16']['test_error']:.3f}% against f32's "
        f"{100 * report['f32']['train_error']:.3f}% / {100 * report['f32']['test_error']:.3f}%")
    check(f"{BLOCK_RESIDENT}: the bf16 bank's fit is finite",
          bool(torch.isfinite(fitted["bf16"].W_stack).all()), f"weights gap {rel_bf16:.3e}")
    del fitted, model, train, test, labels, Wrf, brf
    torch.cuda.empty_cache()
    return report


def phase_wide_auto(cuda_ops, timit, TimitConfig):
    """Phase 12(c): TIMIT --solver auto at d = 204,800 on WIDE_N rows, on the
    card's own budget: the block-streamed tier."""
    from keystone_tpu_torch.ops.learning import streaming_ls

    fits = []
    fit = streaming_ls.BlockStreamedLeastSquares.fit

    def recorded(self, data, labels):
        fits.append(self.block_size)
        return fit(self, data, labels)

    streaming_ls.BlockStreamedLeastSquares.fit = recorded
    try:
        result, stats = run_auto(cuda_ops, timit, TimitConfig, WIDE_N, WIDE_COSINES)
    finally:
        streaming_ls.BlockStreamedLeastSquares.fit = fit
    counts = stats["launches"]
    models = [op for op in result.fitted.transformer_graph.operators.values()
              if isinstance(op, streaming_ls.StreamingFeaturizedLinearModel)]
    check(f"{WIDE_AUTO}: the selector picks the streaming choice, fitted by "
          f"BlockStreamedLeastSquares at block {BLOCK}",
          stats["winner"] == "StreamingLeastSquaresChoice" and len(models) == 1
          and fits == [BLOCK] and tuple(models[0].W_stack.shape) == (WIDE_BLOCKS, BLOCK, K),
          f"winner {stats['winner']}, streamed models {len(models)}, block-streamed fits "
          f"{fits}")
    decision = result.selector.last_decision
    budget = decision["context"]["hbm_budget_bytes"]
    over = {c["label"]: c["resident_bytes"] / budget for c in decision["candidates"]
            if c["label"] != "StreamingLeastSquaresChoice"}
    (priced,) = [c["resident_bytes"] for c in decision["candidates"]
                 if c["label"] == "StreamingLeastSquaresChoice"]
    # The compressed gram engine's int16 indices cannot hold d > 32,767: it
    # is priced infinite, which JSON spells as a string here.
    stats.update(resident_over_budget={name: v if v != float("inf") else "inf"
                                       for name, v in over.items()},
                 priced_resident_bytes=priced, budget_bytes=budget)
    check(f"{WIDE_AUTO}: every resident candidate over the budget by more than 5%",
          all(v > 1.05 for v in over.values()), f"resident / budget {over}")
    check(f"{WIDE_AUTO} launches", same_launches(counts, WIDE_LAUNCHES),
          f"{counts}, expected {WIDE_LAUNCHES}")
    check_metrics(WIDE_AUTO, result.train_eval, result.test_eval, WIDE_N)
    peak = stats["peak_allocated_bytes"]
    grown = peak - stats["baseline_allocated_bytes"]
    stats.update(run_peak_bytes=grown, run_peak_over_priced=grown / priced)
    log(f"  (c) d={WIDE_D}: peak allocated {peak / 2**30:.3f} GiB, {grown / 2**30:.3f} GiB of "
        f"it allocated by the run ({grown / priced:.4f} of the priced {priced / 2**30:.3f} GiB, "
        f"{priced:.4g} B), against the {budget / 2**30:.3f} GiB budget")
    check(f"{WIDE_AUTO}: peak under the budget", peak <= budget,
          f"{peak / 2**30:.3f} GiB <= {budget / 2**30:.3f} GiB")
    check(f"{WIDE_AUTO}: the run's peak within {WIDE_PEAK_OVER_PRICED:.0%} over the priced "
          "resident bytes", grown <= (1 + WIDE_PEAK_OVER_PRICED) * priced,
          f"{grown / 2**30:.3f} GiB <= {(1 + WIDE_PEAK_OVER_PRICED) * priced / 2**30:.3f} GiB")
    del result, models
    torch.cuda.empty_cache()
    return stats


def phase_wide_breakdown(cuda_ops):
    """Phase 12(c), where the fit's and the apply's time goes: each call of
    one block step at the route's shapes (WIDE_N rows, a 4,096-wide slice
    of a bank, k = 147), and of one apply tile (WIDE_TILE rows against the
    whole 204,800-wide bank), timed alone (``time_ms``: CUDA events, median
    of 5 after a warm-up), times its count in the run."""
    from keystone_tpu_torch.parallel.linalg import _psd_factor, _solve_psd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    X = torch.randn((WIDE_N, D_IN), generator=gen, device=dev) * 0.6
    W = torch.randn((WIDE_D, D_IN), generator=gen, device=dev) * 0.05555
    b = torch.rand((WIDE_D,), generator=gen, device=dev) * 6.283185307179586
    Wb, bb = W[:BLOCK], b[:BLOCK]
    R = torch.randn((WIDE_N, K), generator=gen, device=dev)
    F = cuda_ops.cosine_features(X, Wb, bb)
    gram, corr = cuda_ops.gram_corr_sym(F, R)
    chol = _psd_factor(gram, 0.0)
    dW = torch.randn((BLOCK, K), generator=gen, device=dev) * 0.01
    Wf = torch.randn((WIDE_D, K), generator=gen, device=dev) * 0.01
    Xt = X[:WIDE_TILE]
    Ft = cuda_ops.cosine_features(Xt, W, b)
    calls = {
        # name: (call, count in the fit or the apply)
        "fit: cosine_features": (lambda: cuda_ops.cosine_features(X, Wb, bb),
                                 EPOCHS * WIDE_BLOCKS),
        "fit: gram_corr_sym": (lambda: cuda_ops.gram_corr_sym(F, R), WIDE_BLOCKS),
        "fit: column sums": (lambda: F.sum(dim=0, dtype=torch.float32), WIDE_BLOCKS),
        "fit: Cholesky": (lambda: _psd_factor(gram, 0.0), WIDE_BLOCKS),
        "fit: solve and its check": (lambda: _solve_psd(gram, corr, 0.0, chol=chol),
                                     EPOCHS * WIDE_BLOCKS),
        "fit: block_corr": (lambda: cuda_ops.block_corr(F, 0, BLOCK, R),
                            (EPOCHS - 1) * WIDE_BLOCKS),
        "fit: block_residual_update": (
            lambda: cuda_ops.block_residual_update(F, 0, BLOCK, dW, R), EPOCHS * WIDE_BLOCKS),
        "apply: cosine_features": (lambda: cuda_ops.cosine_features(Xt, W, b),
                                   WIDE_LAUNCHES["cosine_features"] - WIDE_COSINES
                                   - EPOCHS * WIDE_BLOCKS),
        "apply: F W": (lambda: Ft @ Wf, WIDE_LAUNCHES["cosine_features"] - WIDE_COSINES
                       - EPOCHS * WIDE_BLOCKS),
    }
    report = {}
    for name, (fn, count) in calls.items():
        ms = time_ms(fn, 5)
        report[name] = dict(ms=ms, count=count, total_s=ms * count / 1e3)
    for part in ("fit", "apply"):
        total = sum(r["total_s"] for name, r in report.items() if name.startswith(part))
        log(f"  (c) {part} by its calls, each timed alone: {total:.3f} s = " + ", ".join(
            f"{name.split(': ')[1]} {r['count']} x {r['ms']:.3f} ms"
            for name, r in report.items() if name.startswith(part)))
        report[f"{part} total_s"] = total
    del X, W, b, R, F, gram, corr, chol, dW, Wf, Ft
    torch.cuda.empty_cache()
    return report


def phase_past_2_31(cuda_ops):
    """Phase 12(d): the block tier's four kernels on one float32 block slab
    of BIG_N x 4,096 (2.42e9 elements, past 2^31). ``cosine_features``
    writes the slab, its last 4,096 rows held against the plain version
    (1e-5, phase 1's tolerance), and ``gram_corr_sym``'s sums of it are
    held against float64 ones (``cosine_gram_f64``). The slab is then
    refilled with integers in {-1, 0, 1} (R and dW too), so that every sum
    the other three kernels make is an integer below 2^24, exact in
    float32 in any order: their outputs must be the plain versions' bits,
    the reductions over the whole slab and the residual update on every
    row. A row read from a wrong offset moves an entry by at least 1."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    n, b, k = BIG_N, BLOCK, K
    X = torch.randn((n, D_IN), generator=gen, device=dev) * 0.6
    W = torch.randn((b, D_IN), generator=gen, device=dev) * 0.05555
    bias = torch.rand((b,), generator=gen, device=dev) * 6.283185307179586
    tail = slice(n - 4096, n)
    F = cuda_ops.cosine_features(X, W, bias)
    want = cuda_ops.cosine_features_ref(X[tail], W, bias)
    err = (F[tail] - want).abs().max().item()
    check(f"cosine_features past 2^31: F {n}x{b} ({n * b:.3g} elements), the last 4,096 rows",
          F.numel() > 2**31 and err <= 1e-5, f"max_abs_err {err:.3e} (tol 1e-5)")
    del X, W, bias, want
    f64 = cosine_gram_f64(cuda_ops, F, gen)
    F.random_(-1, 2, generator=gen)
    R = torch.empty((n, k), device=dev).random_(-1, 2, generator=gen)
    dW = torch.empty((b, k), device=dev).random_(-1, 2, generator=gen)
    gram, corr = cuda_ops.gram_corr_sym(F, R)
    gram_r, corr_r = cuda_ops.gram_corr_sym_ref(F, R)
    gram_ok = torch.equal(gram, gram_r) and torch.equal(corr, corr_r)
    check(f"gram_corr_sym past 2^31: A {n}x{b}, R {n}x{k}, integer entries", gram_ok,
          f"the plain version's bits (max diagonal {gram_r.diagonal().max().item():.0f}, "
          f"exact below 2^24)")
    del gram, gram_r, corr
    got = cuda_ops.block_corr(F, 0, b, R)
    check(f"block_corr past 2^31: F {n}x{b}, R {n}x{k}, integer entries",
          torch.equal(got, cuda_ops.block_corr_ref(F, 0, b, R)) and torch.equal(got, corr_r),
          "the plain version's bits, and gram_corr_sym's correlation")
    del got, corr_r
    out = cuda_ops.block_residual_update(F, 0, b, dW, R)
    want = cuda_ops.block_residual_update_ref(F, 0, b, dW, R)
    check(f"block_residual_update past 2^31: F {n}x{b}, integer entries",
          torch.equal(out, want) and bool((out[tail] != R[tail]).any()),
          "the plain version's bits on every row, the last rows updated")
    torch.cuda.synchronize()
    del F, R, dW, out, want
    torch.cuda.empty_cache()
    return dict(rows=n, elements=n * b, cosine_max_abs_err=err, reductions_exact=True,
                cosine_gram_vs_f64=f64)


def cosine_gram_f64(cuda_ops, F, gen):
    """Phase 12(d)'s precision reading on a cosine slab: the kernel's
    Gramian and correlation (``gram_corr_sym``) and cuBLAS's (the plain
    version, FP32 without TF32) each held against float64 sums made on the
    card in 65,536-row chunks, as max |got - f64| / max |f64|. Integer
    operands show the addressing; this shows how far each float32 sum of
    n terms is from the true one. The kernel's must be at most
    F64_OVER_CUBLAS times cuBLAS's, and under the absolute limits."""
    n, b = F.shape
    R = torch.randn((n, K), generator=gen, device=F.device)
    gram64 = torch.zeros((b, b), dtype=torch.float64, device=F.device)
    corr64 = torch.zeros((b, K), dtype=torch.float64, device=F.device)
    for start in range(0, n, 65536):
        Fc = F[start:start + 65536].double()
        gram64.addmm_(Fc.T, Fc)
        corr64.addmm_(Fc.T, R[start:start + 65536].double())
    del Fc

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    gram, corr = cuda_ops.gram_corr_sym(F, R)
    out = dict(rows=n, kernel_gram=rel(gram, gram64), kernel_corr=rel(corr, corr64))
    del gram, corr
    gram, corr = cuda_ops.gram_corr_sym_ref(F, R)
    out.update(cublas_gram=rel(gram, gram64), cublas_corr=rel(corr, corr64))
    del gram, corr, gram64, corr64, R
    out.update(gram_over_cublas=out["kernel_gram"] / out["cublas_gram"],
               corr_over_cublas=out["kernel_corr"] / out["cublas_corr"])
    log(f"  (d) cosine-valued Gramian and correlation of the {n}x{b} slab against float64 "
        f"sums (max |err| / max |f64|): gram_corr_sym {out['kernel_gram']:.3e} and "
        f"{out['kernel_corr']:.3e}, cuBLAS {out['cublas_gram']:.3e} and "
        f"{out['cublas_corr']:.3e} (kernel over cuBLAS {out['gram_over_cublas']:.3f} and "
        f"{out['corr_over_cublas']:.3f})")
    check(f"gram_corr_sym on {n} rows of cosine values: within {F64_OVER_CUBLAS}x cuBLAS's "
          f"distance from float64 sums, and within {GRAM_F64_TOL:.0e} (Gramian) and "
          f"{CORR_F64_TOL:.0e} (correlation)",
          out["gram_over_cublas"] <= F64_OVER_CUBLAS and out["corr_over_cublas"]
          <= F64_OVER_CUBLAS and out["kernel_gram"] <= GRAM_F64_TOL
          and out["kernel_corr"] <= CORR_F64_TOL,
          f"Gramian {out['kernel_gram']:.3e} ({out['gram_over_cublas']:.3f}x cuBLAS), "
          f"correlation {out['kernel_corr']:.3e} ({out['corr_over_cublas']:.3f}x cuBLAS)")
    return out


def phase_north_star_f64(cuda_ops):
    """Phase 12(d) at the north star's n: ``cosine_features`` writes one
    float32 block slab of NORTH_N x BLOCK (36 GB) and ``gram_corr_sym``'s
    sums of it are held against float64 ones (``cosine_gram_f64``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    X = torch.randn((NORTH_N, D_IN), generator=gen, device=dev) * 0.6
    W = torch.randn((BLOCK, D_IN), generator=gen, device=dev) * 0.05555
    bias = torch.rand((BLOCK,), generator=gen, device=dev) * 6.283185307179586
    F = cuda_ops.cosine_features(X, W, bias)
    del X
    out = cosine_gram_f64(cuda_ops, F, gen)
    del F
    torch.cuda.empty_cache()
    return out


def plain_kernels(cuda_ops, names):
    """A context in which each wrapper of ``names`` is its plain version
    (``*_ref``, cuBLAS on the card): a route run inside it is the same
    program with those kernels swapped out, and counts no launch."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        saved = {name: getattr(cuda_ops, name) for name in names}
        try:
            for name in names:
                setattr(cuda_ops, name, getattr(cuda_ops, f"{name}_ref"))
            yield
        finally:
            for name, fn in saved.items():
                setattr(cuda_ops, name, fn)

    return swapped()


def _mnist_weights(result):
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

    (m,) = [o for o in result.fitted.transformer_graph.operators.values()
            if isinstance(o, BlockLinearMapper)]
    return torch.cat([x.float() for x in m.xs])


def _uses_packed_fft(result):
    from keystone_tpu_torch.workflow.fusion import FusedGatherTransformer

    ops = list(result.fitted.transformer_graph.operators.values())
    fused = [o for o in ops if isinstance(o, FusedGatherTransformer)]
    for o in ops:  # a gather fused into the fit (fit first)
        fused += [m for m in getattr(o, "members", []) if isinstance(m, FusedGatherTransformer)]
    return bool(fused) and all(f.uses_packed_fft for f in fused)


def phase_mnist(cuda_ops):
    """Phase 13: MnistRandomFFT. Small on the card against its plain run on
    the CPU (the same errors), then at its own width through ``run``: apply
    first (the reference's order: one ``gram_corr_sym`` launch at A 60,000 x
    2,048, k = 10) and fit first (one launch of each window kernel),
    launches counted from 0. One block and one epoch make the fit an exact
    least-squares solve, so each route's weights are held against float64:
    the solve of the float64 normal equations of the route's own float32
    features (``mnist_f64``), at most F64_OVER_CUBLAS times as far from it
    as the same route with its kernels swapped for their plain versions
    (cuBLAS) on the card. Then ``gram_corr_sym`` alone at that shape."""
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
    from keystone_tpu_torch.workflow import PipelineEnv

    env = PipelineEnv.get_or_create()
    # Two blocks, one epoch: not an exact solve, and the card's float32 and
    # the CPU's round differently, so the small runs are held by their errors.
    small = mnist.MnistRandomFFTConfig(num_ffts=2, block_size=512, synthetic_n=2048)
    card, cpu = [], []
    for dev, into in (("cuda", card), ("cpu", cpu)):
        env.reset()
        r = mnist.run(small, device=dev)
        into += [_mnist_weights(r).cpu(), (r.train_eval.total_error, r.test_eval.total_error)]
    check("MnistRandomFFT small (2 FFTs, 2,048 rows), card against CPU", card[1] == cpu[1],
          f"train and test errors {card[1]} and {cpu[1]} equal; weights "
          f"{_rel(card[0], cpu[0]):.2e} apart")

    config = mnist.MnistRandomFFTConfig(num_ffts=MNIST_FFTS, block_size=MNIST_BLOCK,
                                        synthetic_n=MNIST_N, synthetic_test_n=MNIST_TEST)
    shape = mnist_f64(cuda_ops, config)
    W64 = shape.pop("W64")
    routes = {}
    for fit_first in (False, True):
        label = MNIST_FIT_FIRST if fit_first else MNIST_APPLY_FIRST
        env.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cuda_ops.reset_launch_counts()
        result = mnist.run(config, device="cuda", fit_first=fit_first)
        counts = dict(cuda_ops.launches)
        peak = torch.cuda.max_memory_allocated() - base
        want = {name: MNIST_LAUNCHES[fit_first].get(name, 0) for name in counts}
        W = _mnist_weights(result)
        env.reset()
        with plain_kernels(cuda_ops, list(MNIST_LAUNCHES[fit_first])):
            W_plain = _mnist_weights(mnist.run(config, device="cuda", fit_first=fit_first))
        env.reset()
        err, err_plain = _rel(W, W64), _rel(W_plain, W64)
        errs = (result.train_eval.total_error, result.test_eval.total_error)
        log(f"  {label}: n={MNIST_N}, d={W.shape[0]}, k={MNIST_K}, block {MNIST_BLOCK}: train "
            f"error {100 * errs[0]:.3f}%, test error {100 * errs[1]:.3f}%, "
            f"{'fit' if fit_first else 'fit + train apply'} {result.fit_seconds:.3f} s, "
            f"{'apply (train + test)' if fit_first else 'test apply'} "
            f"{result.apply_seconds:.3f} s, peak allocated by the run {peak / 2**30:.2f} GiB, "
            f"launches {counts}; weights from float64's {err:.3e} (the plain versions' "
            f"{err_plain:.3e})")
        check(f"{label} launches", same_launches(counts, want), f"{counts}, expected {want}")
        check(f"{label}: the gather lowers to the packed FFT", _uses_packed_fft(result),
              "uses_packed_fft on every fused gather")
        check(f"{label}: weights within {F64_OVER_CUBLAS}x the plain versions' distance from "
              f"float64", bool(torch.isfinite(W).all()) and err <= F64_OVER_CUBLAS * err_plain,
              f"{err:.3e} against {err_plain:.3e} relative Frobenius")
        check(f"{label} metrics", result.train_eval.total == MNIST_N
              and result.test_eval.total == MNIST_TEST and errs[1] < 0.5,
              f"every row scored, test error {100 * errs[1]:.3f}% below 50%")
        routes[label] = dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                             peak_allocated_bytes=peak, train_error=errs[0], test_error=errs[1],
                             weights_from_f64=err, plain_weights_from_f64=err_plain,
                             launches=counts)
        del result, W, W_plain
    routes["gram_corr_sym"] = shape
    torch.cuda.empty_cache()
    return routes


def mnist_f64(cuda_ops, config):
    """``gram_corr_sym`` at the MNIST fit's shape: the centred 60,000 x 2,048
    features of the packed gather and the centred ±1 labels (k = 10). Its
    Gramian and correlation and cuBLAS's against float64 sums of the same
    float32 operands (max |err| / max |f64|; the kernel's at most
    F64_OVER_CUBLAS times cuBLAS's), its time against its plain version,
    library call and bound, and its grid. Returns those, and W64: the
    float64 solve of the centred normal equations, the weights an exact
    fit of these features gives."""
    from keystone_tpu_torch.data.loaders import synthetic_mnist
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist

    train = synthetic_mnist(MNIST_N, seed=config.seed, device="cuda")
    A = mnist.build_featurizer(config, "cuda").apply(train.data).get().array
    A = A - A.mean(dim=0)
    R = ClassLabelIndicatorsFromIntLabels(MNIST_K)(train.labels).array
    R = R - R.mean(dim=0)
    m, d = A.shape
    k = R.shape[1]
    G64, C64 = A.double().T @ A.double(), A.double().T @ R.double()

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    gram, corr = cuda_ops.gram_corr_sym(A, R)
    r = dict(rows=m, d=d, k=k, kernel_gram=rel(gram, G64), kernel_corr=rel(corr, C64))
    gram, corr = cuda_ops.gram_corr_sym_ref(A, R)
    r.update(cublas_gram=rel(gram, G64), cublas_corr=rel(corr, C64))
    log(f"  gram_corr_sym at the MNIST shape, A {m}x{d}, R {m}x{k}, against float64 sums "
        f"(max |err| / max |f64|): Gramian {r['kernel_gram']:.3e}, correlation "
        f"{r['kernel_corr']:.3e}; cuBLAS {r['cublas_gram']:.3e} and {r['cublas_corr']:.3e}")
    check(f"gram_corr_sym at the MNIST fit's shape: within {F64_OVER_CUBLAS}x cuBLAS's distance "
          f"from float64 sums", r["kernel_gram"] <= F64_OVER_CUBLAS * r["cublas_gram"]
          and r["kernel_corr"] <= F64_OVER_CUBLAS * r["cublas_corr"],
          f"Gramian {r['kernel_gram'] / r['cublas_gram']:.3f}x, correlation "
          f"{r['kernel_corr'] / r['cublas_corr']:.3f}x cuBLAS's")
    W64 = torch.linalg.solve(G64, C64)
    del gram, corr, G64, C64
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr_sym(A, R), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_ref(A, R), 10)
    r["library_ms"] = time_ms(lambda: (A.T @ A, A.T @ R), 10)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * d + m * k + d * d + d * k),
                                            m * d * (d + 1) + 2 * m * d * k, PEAK_F32_FLOPS)
    grid = r["grid"] = cuda_ops.gram_corr_grid(A, k)
    log(f"  gram_corr_sym at the MNIST shape: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}, "
        f"{r['bound_ms'] / r['ms']:.0%} of it); grid {grid['corr_blocks']} correlation blocks "
        f"({grid['ktile']}-wide label tile, {grid['masked']:.1%} masked) and "
        f"{grid['gram_blocks']} Gramian tiles: {grid_line(grid)}")
    del A, R, train
    r["W64"] = W64
    return r


class _StageClock:
    """Wall seconds by stage of a pipeline: each wrapped method's calls
    summed under its stage (host stages end where their output is a host
    object; device stages end in a device synchronize). ``calls`` lists each
    call's stage and receiver."""

    def __init__(self):
        self.seconds = {}
        self.calls = []
        self._saved = []

    def wrap(self, owner, attr, stage, sync=False):
        fn = getattr(owner, attr)
        clock = self

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            clock.seconds[stage] = clock.seconds.get(stage, 0.0) + time.perf_counter() - t0
            clock.calls.append((stage, args[0] if args else None))
            return out

        self._saved.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)


def phase_amazon():
    """Phase 14: AmazonReviewsPipeline. Its L-BFGS on the card against the
    port's CPU run on the first AMAZON_SMALL documents (the loss after
    every step within LBFGS_TOL), then the pipeline through ``run`` on
    AMAZON_DOCS training and a quarter as many test documents: host seconds
    by stage (text nodes, term counts, feature selection, vectorizing,
    densifying) apart from the L-BFGS's device seconds, its steps, final
    loss and the accuracy. No hand-written kernel is on this path: every
    launch count stays 0."""
    from keystone_tpu_torch.ops import nlp, sparse
    from keystone_tpu_torch.ops.learning import classifiers
    from keystone_tpu_torch.ops.stats import TermFrequency
    from keystone_tpu_torch.pipelines import amazon_reviews as amazon
    from keystone_tpu_torch.workflow import PipelineEnv
    from keystone_tpu_torch.ops import cuda_ops

    env = PipelineEnv.get_or_create()
    small = amazon.AmazonReviewsConfig(synthetic_n=AMAZON_SMALL,
                                       common_features=AMAZON_FEATURES,
                                       num_iters=AMAZON_LR_ITERS)
    fits = {}
    for dev in ("cuda", "cpu"):
        env.reset()
        fits[dev] = amazon.run(small, device=dev).estimator.last_fit
    card, cpu = fits["cuda"], fits["cpu"]
    worst = max((abs(a - b) / abs(b) for a, b in zip(card.losses, cpu.losses)), default=0.0)
    check(f"AmazonReviewsPipeline small ({AMAZON_SMALL} documents): the card's L-BFGS losses "
          f"against the CPU's", card.iterations == cpu.iterations and worst <= LBFGS_TOL,
          f"{card.iterations} and {cpu.iterations} steps, largest relative gap of the loss "
          f"after a step {worst:.2e} (tol {LBFGS_TOL:.0e})")

    clock = _StageClock()
    for owner, attr, stage in (
        (nlp.Trim, "batch_apply", "text nodes"), (nlp.LowerCase, "batch_apply", "text nodes"),
        (nlp.Tokenizer, "batch_apply", "text nodes"),
        (nlp.NGramsFeaturizer, "batch_apply", "text nodes"),
        (TermFrequency, "batch_apply", "term counts"),
        (sparse.CommonSparseFeatures, "fit", "feature selection"),
        (sparse.SparseFeatureVectorizer, "batch_apply", "vectorize"),
    ):
        clock.wrap(owner, attr, stage)
    clock.wrap(classifiers, "_dense_on", "densify", sync=True)
    clock.wrap(classifiers, "logistic_lbfgs", "L-BFGS (device)", sync=True)
    config = amazon.AmazonReviewsConfig(synthetic_n=AMAZON_DOCS, common_features=AMAZON_FEATURES,
                                        num_iters=AMAZON_LR_ITERS)
    env.reset()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = amazon.run(config, device="cuda")
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    env.reset()
    fit = result.estimator.last_fit
    stages = {k: round(v, 3) for k, v in clock.seconds.items()}
    log(f"  {AMAZON_TEXT}: {AMAZON_DOCS} training and {AMAZON_DOCS // 4} test documents, "
        f"{AMAZON_FEATURES} features, {AMAZON_LR_ITERS} iterations: run {wall:.3f} s (data "
        f"generation included; fit + train apply {result.fit_seconds:.3f} s, test apply "
        f"{result.apply_seconds:.3f} s); by stage {stages}; L-BFGS {fit.iterations} steps, "
        f"final loss {fit.loss:.6g}, trial steps {fit.linesearch_steps}; accuracy train "
        f"{100 * result.train_eval.accuracy:.3f}%, test {100 * result.test_eval.accuracy:.3f}%")
    check(f"{AMAZON_TEXT} launches no kernel but the row-stable product",
          same_launches(counts, {}), f"{counts}")
    check(f"{AMAZON_TEXT} metrics", np.isfinite(fit.loss) and fit.iterations >= 1
          and result.test_eval.tp + result.test_eval.fp + result.test_eval.tn
          + result.test_eval.fn == AMAZON_DOCS // 4 and result.test_eval.accuracy > 0.5,
          f"finite loss, {fit.iterations} steps, every test document scored, test accuracy "
          f"{100 * result.test_eval.accuracy:.3f}% above 50%")
    return dict(documents=AMAZON_DOCS, test_documents=AMAZON_DOCS // 4, run_seconds=wall,
                fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                stage_seconds=stages, iterations=fit.iterations, final_loss=fit.loss,
                losses=fit.losses, train_accuracy=result.train_eval.accuracy,
                test_accuracy=result.test_eval.accuracy, small_loss_gap=worst)


def _textures(n, size, seed):
    """Smooth oriented textures plus noise in [0, 1], as (n, size, size, 3)
    float32: images with real gradients for SIFT."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = []
    for _ in range(n):
        f = rng.uniform(0.2, 1.5, size=2)
        img = 0.5 + 0.35 * np.sin(f[0] * xx + f[1] * yy) + 0.08 * rng.normal(size=(size, size))
        out.append(np.clip(img, 0, 1))
    return torch.from_numpy(np.stack(out).astype(np.float32)[..., None].repeat(3, axis=-1))


def phase_images_small(device="cuda"):
    """The image featurizer's modules small on the card against the CPU:
    SIFT (quantized: no entry more than one step off, at most 0.1% of the
    entries off), LCS and Fisher vectors (1e-5), the GMM's fit (the same
    k-means++ picks, parameters within 1e-6 relative, the same EM steps,
    no restart) and BWLS in float64 (1e-6 relative)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.images.fisher import FisherVector
    from keystone_tpu_torch.ops.images.lcs import LCSExtractor
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor
    from keystone_tpu_torch.ops.learning.bwls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.clustering import (
        GaussianMixtureModelEstimator,
        KMeansPlusPlusEstimator,
    )

    imgs = _textures(32, VOC_SIZE, 3)
    on = {where: imgs.to(where) for where in (device, "cpu")}
    sift = {w: SIFTExtractor().batch_apply(Dataset(x)).array.cpu() for w, x in on.items()}
    diff = (sift[device] - sift["cpu"]).abs()
    share = float((diff > 0).float().mean())
    check(f"SIFT on 32 images of {VOC_SIZE} x {VOC_SIZE}, card against CPU",
          float(diff.max()) <= 1.0 and share <= 1e-3,
          f"largest difference {float(diff.max()):.0f} step, {share:.2e} of the entries differ "
          f"(tol 1 step, 1e-3)")
    lcs = {w: LCSExtractor(4, 16, 6).batch_apply(Dataset(x)).array.cpu() for w, x in on.items()}
    err = float((lcs[device] - lcs["cpu"]).abs().max())
    check("LCS, card against CPU", err <= 1e-5, f"max_abs_err {err:.2e} (tol 1e-5)")

    rng = np.random.default_rng(5)
    centres = rng.normal(scale=4.0, size=(8, 16))
    X = torch.from_numpy(centres[rng.integers(0, 8, 20000)] + rng.normal(size=(20000, 16)))
    fits = {}
    for where in (device, "cpu"):
        est = GaussianMixtureModelEstimator(8, seed=2)
        centers = KMeansPlusPlusEstimator(8, 10, seed=2).seed_centers(X.to(where))
        gmm = est.fit_array(X.to(where))
        fits[where] = (centers, gmm, est.iterations, est.restarts)
    (c_g, g_g, it_g, rs_g), (c_c, g_c, it_c, rs_c) = fits[device], fits["cpu"]
    rel = max(float((getattr(g_g, a).cpu() - getattr(g_c, a)).abs().max()
                    / getattr(g_c, a).abs().max()) for a in ("means", "variances", "weights"))
    check("GMM fit on 20,000 x 16 (k = 8), card against CPU",
          (c_g == c_c).all() and rel <= 1e-6 and it_g == it_c and rs_g == rs_c == 0,
          f"the same k-means++ picks, parameters within {rel:.2e} relative (tol 1e-6), "
          f"{it_g} and {it_c} EM steps, restarts {rs_g} and {rs_c}")
    desc = torch.from_numpy(rng.normal(size=(12, 16, 60)).astype(np.float32))
    fv = {w: FisherVector(g).batch_apply(Dataset(desc.to(w))).array.cpu()
          for w, g in ((device, g_g), ("cpu", g_c))}
    err = float((fv[device] - fv["cpu"]).abs().max())
    check("Fisher vectors, card against CPU", err <= 1e-5, f"max_abs_err {err:.2e} (tol 1e-5)")

    labels = rng.integers(0, 30, 600)
    F = torch.from_numpy(rng.normal(size=(30, 256))[labels] + rng.normal(size=(600, 256)))
    Y = torch.from_numpy(2.0 * np.eye(30)[labels] - 1.0)
    W = {}
    for where in (device, "cpu"):
        m = BlockWeightedLeastSquaresEstimator(128, 1, 6e-5, 0.25).fit(
            Dataset(F.to(where)), Dataset(Y.to(where)))
        W[where] = torch.cat([x.cpu() for x in m.xs])
    rel = float((W[device] - W["cpu"]).norm() / W["cpu"].norm())
    check("BWLS float64 (600 x 256, 30 classes), card against CPU", rel <= 1e-6,
          f"weights {rel:.2e} relative Frobenius (tol 1e-6)")


def _image_stage_clock(device):
    """A stage clock over the image pipelines' stages (each call ending in
    a device synchronize)."""
    from keystone_tpu_torch.ops.images.fisher import FisherVector
    from keystone_tpu_torch.ops.images.lcs import LCSExtractor
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor
    from keystone_tpu_torch.ops.learning import block, bwls, clustering, pca

    clock = _StageClock()
    sync = torch.device(device).type == "cuda"
    for owner, attr, stage in (
        (SIFTExtractor, "batch_apply", "SIFT"), (LCSExtractor, "batch_apply", "LCS"),
        (pca.DistributedColumnPCAEstimator, "fit", "column PCA fit"),
        (pca.LocalColumnPCAEstimator, "fit", "column PCA fit"),
        (clustering.KMeansPlusPlusEstimator, "fit_array", "k-means++ and Lloyd"),
        (clustering.GaussianMixtureModelEstimator, "fit_array", "GMM fit"),
        (FisherVector, "batch_apply", "Fisher vectors"),
        (block.BlockLeastSquaresEstimator, "fit", "solve"),
        (bwls.BlockWeightedLeastSquaresEstimator, "fit", "solve"),
    ):
        clock.wrap(owner, attr, stage, sync=sync)
    return clock


def _stage_seconds(clock):
    """Seconds by stage, the GMM's EM apart from its k-means++ init; and
    each GMM fit's EM steps and restarts."""
    stages = dict(clock.seconds)
    if "GMM fit" in stages:
        stages["GMM EM"] = stages.pop("GMM fit") - stages.get("k-means++ and Lloyd", 0.0)
    gmms = [(est.iterations, est.restarts) for stage, est in clock.calls if stage == "GMM fit"]
    return {k: round(v, 3) for k, v in stages.items()}, gmms


def phase_voc(cuda_ops, device="cuda"):
    """Phase 15: VOCSIFTFisher through ``voc_sift_fisher.run`` at d = 40,960
    on VOC 2007's 5,011 + 4,952 images (64 x 64 synthetic), launches
    counted from 0: exactly VOC_BLOCKS ``gram_corr_sym`` launches and no
    other kernel. Host seconds by stage, fit, apply, peak memory, MAP; the
    fit's weights against the same fit on the same features with
    ``gram_corr_sym`` swapped for its plain version, and both against that
    fit in float64 (the kernel's at most F64_OVER_CUBLAS times as far)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.pipelines import voc_sift_fisher as voc
    from keystone_tpu_torch.workflow import PipelineEnv

    env = PipelineEnv.get_or_create()
    config = voc.VOCConfig(lam=VOC_LAM, descriptor_dim=VOC_DESC, vocab_size=VOC_VOCAB,
                           block_size=VOC_BLOCK, synthetic_n=VOC_N, synthetic_test_n=VOC_TEST,
                           synthetic_image_size=VOC_SIZE)
    seen = []
    fit = BlockLeastSquaresEstimator.fit

    def keeping_fit(self, data, labels):
        seen.append((data, labels))
        return fit(self, data, labels)

    BlockLeastSquaresEstimator.fit = keeping_fit
    clock = _image_stage_clock(device)
    env.reset()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = voc.run(config, device=device)
    finally:
        clock.restore()
        BlockLeastSquaresEstimator.fit = fit
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else 0
    env.reset()
    stages, gmms = _stage_seconds(clock)
    (mapper,) = [o for o in result.fitted.transformer_graph.operators.values()
                 if type(o).__name__ == "BlockLinearMapper"]
    W = torch.cat([x.float() for x in mapper.xs])
    (data, labels), = seen
    with plain_kernels(cuda_ops, ["gram_corr_sym"]):
        plain = BlockLeastSquaresEstimator(VOC_BLOCK, 1, VOC_LAM).fit(data, labels)
    W_plain = torch.cat([x.float() for x in plain.xs])
    rel = _rel(W, W_plain)
    # The same fit in float64 on the same float32 features (plain
    # contractions): the sums the kernel and cuBLAS both approximate.
    fit64 = BlockLeastSquaresEstimator(VOC_BLOCK, 1, VOC_LAM).fit(
        Dataset(data.array.double(), n=data.n), Dataset(labels.array.double(), n=labels.n))
    W64 = torch.cat(list(fit64.xs))
    err, err_plain = _rel(W, W64), _rel(W_plain, W64)
    del seen, data, labels, plain, fit64
    log(f"  {VOC}: {VOC_N} training and {VOC_TEST} test images of {VOC_SIZE} x {VOC_SIZE}, "
        f"d = {W.shape[0]}, k = {W.shape[1]}: run {wall:.3f} s (data generation included; fit "
        f"{result.fit_seconds:.3f} s, test apply {result.apply_seconds:.3f} s), peak allocated "
        f"by the run {peak / 2**30:.2f} GiB; by stage {stages}; GMM (EM steps, restarts) "
        f"{gmms}; MAP {result.mean_ap:.4f}; "
        f"launches {counts}; weights {rel:.2e} from the fit with gram_corr_sym's plain version; "
        f"from the float64 fit {err:.3e} (the plain version's {err_plain:.3e})")
    expected = {name: 0 for name in counts}
    expected["gram_corr_sym"] = VOC_BLOCKS
    check(f"{VOC} launches", same_launches(counts, expected), f"{counts}, expected {expected}")
    check(f"{VOC} width", W.shape == (VOC_D, VOC_K) and len(mapper.xs) == VOC_BLOCKS,
          f"weights {tuple(W.shape)} in {len(mapper.xs)} blocks")
    check(f"{VOC} weights against the plain versions'", bool(torch.isfinite(W).all())
          and rel <= VOC_PLAIN_TOL, f"{rel:.2e} relative Frobenius (tol {VOC_PLAIN_TOL:.0e})")
    check(f"{VOC} weights within {F64_OVER_CUBLAS}x the plain versions' distance from float64",
          err <= F64_OVER_CUBLAS * err_plain, f"{err:.3e} against {err_plain:.3e}")
    aps = np.asarray(result.aps)
    check(f"{VOC} metrics", aps.shape == (VOC_K,) and np.isfinite(aps).all()
          and result.mean_ap > 0.5, f"20 finite APs, MAP {result.mean_ap:.4f} above 0.5 "
          f"(chance is about 0.1)")
    return dict(train_images=VOC_N, test_images=VOC_TEST, image_size=VOC_SIZE, d=VOC_D,
                run_seconds=wall, fit_seconds=result.fit_seconds,
                apply_seconds=result.apply_seconds, peak_allocated_bytes=peak,
                stage_seconds=stages, gmm_steps_restarts=gmms, mean_ap=result.mean_ap,
                aps=aps.tolist(), weights_vs_plain=rel, weights_from_f64=err,
                plain_weights_from_f64=err_plain, launches=counts)


def phase_imagenet(cuda_ops, device="cuda"):
    """Phase 16: ImageNetSiftLcsFV through ``imagenet_sift_lcs_fv.run`` at
    the reference config's widths (d = 4,096) and 1,000 classes, 16,000 +
    5,000 images of 64 x 64, launches counted from 0 (no kernel is on this
    route). Host seconds by stage, fit, apply, peak memory, top-1 and top-5
    errors."""
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as inet
    from keystone_tpu_torch.workflow import PipelineEnv

    env = PipelineEnv.get_or_create()
    config = inet.ImageNetConfig(synthetic_n=INET_N, synthetic_test_n=INET_TEST,
                                 synthetic_classes=INET_CLASSES, synthetic_image_size=INET_SIZE)
    clock = _image_stage_clock(device)
    env.reset()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = inet.run(config, device=device)
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else 0
    env.reset()
    stages, gmms = _stage_seconds(clock)
    (mapper,) = [o for o in result.fitted.transformer_graph.operators.values()
                 if type(o).__name__ == "BlockLinearMapper"]
    W = torch.cat([x.float() for x in mapper.xs])
    top1 = result.top1_eval.total_error
    log(f"  {IMAGENET}: {INET_N} training and {INET_TEST} test images of {INET_SIZE} x "
        f"{INET_SIZE}, {INET_CLASSES} classes, d = {W.shape[0]}: run {wall:.3f} s (data "
        f"generation included; fit {result.fit_seconds:.3f} s, test apply "
        f"{result.apply_seconds:.3f} s), peak allocated by the run {peak / 2**30:.2f} GiB; by "
        f"stage {stages}; GMM (EM steps, restarts) {gmms}; top-1 error {100 * top1:.2f}%, "
        f"top-5 error {100 * result.top5_error:.2f}%; launches {counts}")
    check(f"{IMAGENET} launches no kernel but the row-stable product (its BWLS model's apply)",
          same_launches(counts, {}), f"{counts}")
    check(f"{IMAGENET} width", W.shape == (4096, INET_CLASSES) and bool(torch.isfinite(W).all()),
          f"finite weights {tuple(W.shape)}")
    check(f"{IMAGENET} metrics", result.top5.shape == (INET_TEST, 5)
          and result.top1_eval.total == INET_TEST and result.top5_error < 0.9,
          f"every test image scored, top-5 error {100 * result.top5_error:.2f}% below 90% "
          f"(chance is 99.5%)")
    return dict(train_images=INET_N, test_images=INET_TEST, classes=INET_CLASSES, d=4096,
                run_seconds=wall, fit_seconds=result.fit_seconds,
                apply_seconds=result.apply_seconds, peak_allocated_bytes=peak,
                stage_seconds=stages, gmm_steps_restarts=gmms, top1_error=top1,
                top5_error=result.top5_error,
                launches=counts)


def _peak_window(device):
    """Start a peak-memory window; returns a function that reads the peak
    allocated by what ran since, and a function that synchronizes."""
    cuda = torch.device(device).type == "cuda"
    if not cuda:
        return (lambda: 0), (lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    return (lambda: torch.cuda.max_memory_allocated() - base), torch.cuda.synchronize


def cifar_runner_config(cifar):
    """Phase 6's geometry for the block runners: 50,000 training and 12,500
    test images, 100 filters, blocks of 512, lambda 10, 1 epoch."""
    return cifar.CifarConfig(synthetic_n=CIFAR_N, num_filters=CIFAR_FILTERS,
                             block_size=CIFAR_BLOCK, lam=10.0, num_epochs=1)


def cifar_runner_launches(cuda_ops, fusion, name):
    """A runner's predicted launches in one apply-first run: the fused
    featurizer's row chunks of the training and test images (crops for the
    augmented runner) from the chunk budget, once each; no other kernel
    (the block fits are stepwise at 1,800 and 800 features in blocks of
    512, as the reference's are)."""
    expected = {k: 0 for k in cuda_ops.launches}
    if name in ("RandomCifar", "RandomPatchCifar"):
        expected["conv_featurize"] = (_conv_launches(fusion, CIFAR_N)
                                      + _conv_launches(fusion, CIFAR_TEST))
    elif name == "RandomPatchCifarAugmented":
        expected["conv_featurize"] = (
            _conv_launches(fusion, CIFAR_N * AUG_PATCHES, AUG_ROW_BYTES)
            + _conv_launches(fusion, CIFAR_TEST * AUG_TEST_PATCHES, AUG_ROW_BYTES))
    return expected


def phase_cifar_runners(cuda_ops, fusion, device="cuda"):
    """Phase 17(b): the four CIFAR runners through ``cifar.RUNNERS`` at
    phase 6's geometry, each with the launch counts set to 0 just before
    and read just after, and held to the prediction: ``conv_featurize``
    once a row chunk of the budget, ``gram_corr_sym`` (and every other
    kernel) 0. Fit and apply seconds, errors, peak allocated by the run."""
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    env = PipelineEnv.get_or_create()
    config = cifar_runner_config(cifar)
    report = {}
    for name in ("LinearPixels", "RandomCifar", "RandomPatchCifar",
                 "RandomPatchCifarAugmented"):
        env.reset()
        expected = cifar_runner_launches(cuda_ops, fusion, name)
        peak, _ = _peak_window(device)
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = cifar.RUNNERS[name](config, device=device)
        wall = time.perf_counter() - t0
        counts = dict(cuda_ops.launches)
        peak_bytes = peak()
        env.reset()
        aug = name == "RandomPatchCifarAugmented"
        train_total = CIFAR_N * (AUG_PATCHES if aug else 1)
        train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
        log(f"  {name}: {train_total} training {'crops' if aug else 'images'}, {CIFAR_TEST} "
            f"test images{' (5 crops each, voted)' if aug else ''}: train error "
            f"{100 * train_err:.3f}%, test error {100 * test_err:.3f}%, fit (and train apply) "
            f"{result.fit_seconds:.3f} s, test apply {result.apply_seconds:.3f} s, run "
            f"{wall:.3f} s (data generation included), peak allocated by the run "
            f"{peak_bytes / 2**30:.2f} GiB, conv_featurize launches {counts['conv_featurize']} "
            f"(predicted {expected['conv_featurize']}), gram_corr_sym "
            f"{counts['gram_corr_sym']}")
        check(f"cifar {name} launches", same_launches(counts, expected),
              f"{counts}, expected {expected}")
        check(f"cifar {name} metrics",
              0.0 <= train_err <= 1.0 and 0.0 <= test_err < 0.9
              and result.train_eval.total == train_total
              and result.test_eval.total == CIFAR_TEST,
              "errors in [0, 1], test error below chance (90%), every image scored")
        report[name] = dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                            run_seconds=wall, peak_allocated_bytes=peak_bytes,
                            train_error=train_err, test_error=test_err, launches=counts)
        del result
    return report


class _ShapeLog:
    """Wraps ``cuda_ops.gaussian_kernel_block`` to log each call's (m, n)
    while it runs (the wrapper's own counter still counts)."""

    def __init__(self, cuda_ops):
        self.cuda_ops, self.fn, self.shapes = cuda_ops, cuda_ops.gaussian_kernel_block, []

    def __enter__(self):
        def logged(X, Y, *args, **kwargs):
            self.shapes.append((int(X.shape[0]), int(Y.shape[0])))
            return self.fn(X, Y, *args, **kwargs)

        self.cuda_ops.gaussian_kernel_block = logged
        return self

    def __exit__(self, *exc):
        self.cuda_ops.gaussian_kernel_block = self.fn


def nystrom_features(device):
    """RandomPatchCifar's standardised training and test features (phase
    17(b)'s filters and whitener) and its ±1 training labels."""
    from keystone_tpu_torch.ops.stats import StandardScaler
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    config = cifar_runner_config(cifar)
    dev = torch.device(device)
    train, test, _ = cifar._load(config, dev)
    filters, whitener = cifar._sample_whitened_filters(train, config)
    featurizer = cifar._conv_featurizer(filters, whitener, config).and_then(
        StandardScaler(), train.data)
    F = featurizer.apply(train.data).get().array
    Ft = featurizer.apply(test.data).get().array
    PipelineEnv.get_or_create().reset()
    Y = ClassLabelIndicatorsFromIntLabels(10)(train.labels).array
    return F, Ft, Y, train.labels.array, test.labels.array


def phase_nystrom(cuda_ops, device="cuda"):
    """Phase 17(c): ``NystromKernelRidge(GaussianKernelGenerator(5e-4),
    lam=10, num_landmarks=2048)`` on RandomPatchCifar's standardised
    training features, with k-means++ and with uniform landmarks, applied
    to the training and test features. Launches counted from 0 for the fit
    and the applies: ``gaussian_kernel_block`` 2 a fit (K(X, L), K(L, L))
    and 1 an apply, logged by shape. Fit seconds (the landmarks' apart),
    errors, and alpha against a float64 solve of the same normal equations
    made on the card from the same K_nm (NYS_F64_TOL relative Frobenius)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.kernel import (
        GaussianKernelGenerator,
        NystromKernelRidge,
    )

    F, Ft, Y, train_labels, test_labels = nystrom_features(device)
    n, m = F.shape[0], min(NYS_M, F.shape[0])
    evaluator = MulticlassClassifierEvaluator(10)
    report = {}
    for kind, kmeans in (("k-means++", True), ("uniform", False)):
        est = NystromKernelRidge(GaussianKernelGenerator(CIFAR_GAMMA), NYS_LAM, NYS_M,
                                 kmeans_landmarks=kmeans, seed=0)
        peak, sync = _peak_window(device)
        landmarks, clock = est.landmarks, {}

        def timed(data, landmarks=landmarks, clock=clock):
            t0 = time.perf_counter()
            L = landmarks(data)
            sync()
            clock["landmarks"] = time.perf_counter() - t0
            return L

        est.landmarks = timed
        cuda_ops.reset_launch_counts()
        with _ShapeLog(cuda_ops) as shapes:
            t0 = time.perf_counter()
            mapper = est.fit(Dataset(F), Dataset(Y))
            sync()
            fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_pred = mapper.batch_apply(Dataset(F)).array
            test_pred = mapper.batch_apply(Dataset(Ft)).array
            sync()
            apply_s = time.perf_counter() - t0
        counts = dict(cuda_ops.launches)
        peak_bytes = peak()
        train_eval = evaluator.evaluate(torch.argmax(train_pred, 1), train_labels)
        test_eval = evaluator.evaluate(torch.argmax(test_pred, 1), test_labels)
        # The same normal equations in float64 from the same K_nm and K_mm,
        # and (for the record, ROADMAP C.7) the reference's float32 ones.
        L = mapper.landmarks
        fn, ln = (F * F).sum(1), (L * L).sum(1)
        K = cuda_ops.gaussian_kernel_block(F, L, fn, ln, CIFAR_GAMMA)
        Kmm = cuda_ops.gaussian_kernel_block(L, L, ln, ln, CIFAR_GAMMA)
        solved = {}
        for dtype in (torch.float64, torch.float32):
            Kd, Kmmd = K.to(dtype), Kmm.to(dtype)
            lhs = Kd.T @ Kd + NYS_LAM * Kmmd
            lhs += 1e-6 * (torch.trace(lhs) / m + 1.0) * torch.eye(m, dtype=dtype,
                                                                    device=lhs.device)
            solved[dtype] = torch.linalg.solve(lhs, Kd.T @ Y.to(dtype))
            del Kd, Kmmd, lhs
        alpha64 = solved[torch.float64]
        rel, rel32 = _rel(mapper.alpha, alpha64), _rel(solved[torch.float32], alpha64)
        pred_rel32 = _rel(K.double() @ solved[torch.float32].double(), K.double() @ alpha64)
        del K, Kmm, solved
        by_shape = {f"{a}x{b}": shapes.shapes.count((a, b)) for a, b in sorted(set(shapes.shapes))}
        log(f"  Nystrom KRR, {kind} landmarks (m = {m}, n = {n}, d = {F.shape[1]}): landmarks "
            f"{clock['landmarks']:.3f} s, fit {fit_s:.3f} s (landmarks included), train and "
            f"test apply {apply_s:.3f} s, peak allocated {peak_bytes / 2**30:.2f} GiB; train "
            f"error {100 * train_eval.total_error:.3f}%, test error "
            f"{100 * test_eval.total_error:.3f}%; gaussian_kernel_block launches by shape "
            f"{by_shape}; alpha {rel:.3e} from the float64 solve (tol {NYS_F64_TOL:.0e}); the "
            f"reference's float32 normal equations {rel32:.3e} (their training predictions "
            f"{pred_rel32:.3e})")
        expected = {k: 0 for k in counts}
        expected["gaussian_kernel_block"] = 4
        check(f"nystrom {kind} launches: 2 a fit, 1 an apply", same_launches(counts, expected)
              and sorted(shapes.shapes) == sorted([(n, m), (m, m), (n, m), (Ft.shape[0], m)]),
              f"{counts}, shapes {shapes.shapes}")
        check(f"nystrom {kind} alpha against the float64 solve",
              bool(torch.isfinite(mapper.alpha).all()) and rel <= NYS_F64_TOL,
              f"{rel:.3e} relative Frobenius (tol {NYS_F64_TOL:.0e})")
        check(f"nystrom {kind} metrics", train_eval.total == n and test_eval.total == Ft.shape[0]
              and test_eval.total_error < 0.9, "every row scored, test error below chance")
        report[kind] = dict(landmark_seconds=clock["landmarks"], fit_seconds=fit_s,
                            apply_seconds=apply_s, peak_allocated_bytes=peak_bytes,
                            train_error=train_eval.total_error,
                            test_error=test_eval.total_error, alpha_vs_f64=rel,
                            f32_alpha_vs_f64=rel32, f32_predictions_vs_f64=pred_rel32,
                            launches=counts, launches_by_shape=by_shape)
        del mapper, train_pred, test_pred
    return report


def phase_newsgroups(cuda_ops, device="cuda"):
    """Phase 17(d): NewsgroupsPipeline through ``newsgroups.run`` on
    synthetic_documents at 20 Newsgroups' split sizes, bigrams: n, d and
    the dense bytes the naive Bayes fit densifies, fit and apply seconds,
    errors, peak; no kernel is on this route."""
    from keystone_tpu_torch.ops.learning.classifiers import NaiveBayesModel
    from keystone_tpu_torch.pipelines import newsgroups
    from keystone_tpu_torch.workflow import PipelineEnv

    env = PipelineEnv.get_or_create()
    env.reset()
    config = newsgroups.NewsgroupsConfig(synthetic_n=NEWS_N, synthetic_test_n=NEWS_TEST,
                                         synthetic_classes=NEWS_CLASSES, n_grams=2)
    peak, _ = _peak_window(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = newsgroups.run(config, device=device)
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak_bytes = peak()
    (model,) = [op for op in result.pipeline.fit().transformer_graph.operators.values()
                if isinstance(op, NaiveBayesModel)]
    env.reset()
    d = int(model.theta.shape[1])
    dense = NEWS_N * d * model.theta.element_size()
    log(f"  NewsgroupsPipeline: n = {NEWS_N} training and {NEWS_TEST} test documents, "
        f"{NEWS_CLASSES} classes, bigrams: d = {d}, dense training matrix {NEWS_N} x {d} = "
        f"{dense / 2**30:.3f} GiB ({model.theta.dtype}); fit (and train apply) "
        f"{result.fit_seconds:.3f} s, test apply {result.apply_seconds:.3f} s, run {wall:.3f} s, "
        f"peak allocated {peak_bytes / 2**30:.2f} GiB; train error "
        f"{100 * result.train_eval.total_error:.3f}%, test error "
        f"{100 * result.test_eval.total_error:.3f}%")
    check("newsgroups launches no kernel but the row-stable product",
          same_launches(counts, {}), f"{counts}")
    check("newsgroups metrics", result.train_eval.total == NEWS_N
          and result.test_eval.total == NEWS_TEST and result.test_eval.total_error < 0.95
          and bool(torch.isfinite(model.theta).all()),
          "every document scored, test error below chance (95%), finite model")
    return dict(n=NEWS_N, d=d, dense_bytes=dense, fit_seconds=result.fit_seconds,
                apply_seconds=result.apply_seconds, run_seconds=wall,
                peak_allocated_bytes=peak_bytes, train_error=result.train_eval.total_error,
                test_error=result.test_eval.total_error)


def phase_stupid_backoff():
    """Phase 17(e): StupidBackoffPipeline through ``stupid_backoff.run`` on
    synthetic_sentences(SB_SENTENCES), n = 3, alpha 0.4: the n-gram count
    and seconds, every score in (0, 1], and the vectorised packed scorer
    equal to the dict loop (``_score_locally``) on SB_SAMPLE n-grams, half
    observed and half random word-id tuples (most of them backing off)."""
    from keystone_tpu_torch.ops.nlp import NGram
    from keystone_tpu_torch.pipelines import stupid_backoff

    t0 = time.perf_counter()
    model, encoder = stupid_backoff.run(stupid_backoff.StupidBackoffConfig(
        n=SB_ORDER, alpha=SB_ALPHA, synthetic_n=SB_SENTENCES))
    fit_s = time.perf_counter() - t0
    scores = np.fromiter(model.scores.values(), dtype=np.float64, count=len(model.scores))
    rng = np.random.default_rng(0)
    observed = list(model.ngram_counts)
    half = SB_SAMPLE // 2
    sample = [observed[i] for i in rng.choice(len(observed), half, replace=False)]
    vocab = len(encoder.word_index)
    orders = rng.integers(2, SB_ORDER + 1, size=SB_SAMPLE - half)
    sample += [NGram(tuple(int(w) for w in rng.integers(0, vocab, size=o))) for o in orders]
    t0 = time.perf_counter()
    batch = model.batch_score(sample)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = np.array([model.score(g) for g in sample])
    loop_s = time.perf_counter() - t0
    log(f"  StupidBackoffPipeline: {SB_SENTENCES} sentences, n = {SB_ORDER}, alpha "
        f"{SB_ALPHA}: {len(model.scores)} n-grams scored in {fit_s:.3f} s (host); scores in "
        f"[{scores.min():.3e}, {scores.max():.3e}]; {len(sample)} sampled n-grams scored "
        f"vectorised in {1e3 * batch_s:.2f} ms, by the dict loop in {1e3 * loop_s:.2f} ms")
    check("stupid backoff scores in (0, 1]", bool(((scores > 0) & (scores <= 1)).all()),
          f"{len(scores)} scores in [{scores.min():.3e}, {scores.max():.3e}]")
    check("stupid backoff vectorised scorer equals the dict loop", np.array_equal(batch, loop),
          f"{len(sample)} n-grams, {int((batch != loop).sum())} differ")
    return dict(sentences=SB_SENTENCES, ngrams=len(model.scores), fit_seconds=fit_s,
                batch_score_ms=1e3 * batch_s, loop_score_ms=1e3 * loop_s)


def _conv_chunk_rows(fusion, row_bytes=CONV_ROW_BYTES):
    """Images per row chunk of the fused CIFAR featurizer (after its
    one-image probe): the chunk budget over the bytes per image
    (``AUG_ROW_BYTES`` for the augmented runner's 24 x 24 crops)."""
    return fusion.CHUNK_BUDGET_BYTES // row_bytes


def _conv_launches(fusion, n, row_bytes=CONV_ROW_BYTES):
    """The probe, then every image in chunks."""
    return 1 + -(-n // _conv_chunk_rows(fusion, row_bytes))


def gaussian_shape(cuda_ops, label, X, Y, xn, yn, diagonal):
    """gaussian_kernel_block at one shape of the CIFAR route: f32 and bf16
    operands against the plain version (1e-5 absolute; on a diagonal block
    also the clamp: max <= 1, and with f32 operands diagonal >= 1 - 1e-5),
    its grid, and the kernel, plain version, library yardstick and bound in
    ms."""
    m, d = X.shape
    n, g = Y.shape[0], CIFAR_GAMMA
    err = {}
    for dlabel, dtype in (("f32", torch.float32), ("bf16 operands", torch.bfloat16)):
        got = cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g, compute_dtype=dtype)
        want = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g, compute_dtype=dtype)
        torch.cuda.synchronize()
        err[dlabel] = (got - want).abs().max().item()
        ok = err[dlabel] <= 1e-5
        detail = (f"max_abs_err {err[dlabel]:.3e} (tol 1e-5; K in [{want.min().item():.3f}, "
                  f"{want.max().item():.3f}])")
        if diagonal:  # bf16 operands against f32 norms leave the diagonal below 1
            ok = ok and got.max().item() <= 1.0 and (
                dtype == torch.bfloat16 or got.diagonal().min().item() >= 1.0 - 1e-5)
            detail += f"; diagonal >= {got.diagonal().min().item():.7f}, max {got.max().item()}"
        check(f"gaussian_kernel_block {label} {dlabel} X {m}x{d} @ Y {n}x{d}", ok, detail)
        del got, want
    xyn = xn[:, None] + yn[None, :]
    r = dict(max_abs_err=err["f32"])
    reps = 10 if m * n > 1e6 else 50
    r["ms"] = time_ms(lambda: cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g), reps)
    r["device_ms"] = device_ms(lambda: cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g), reps)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g), reps)
    r["library_ms"] = time_ms(
        lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_(), reps)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * d + n * d + m + n + m * n),
                                            2 * m * n * d + 6 * m * n, PEAK_F32_FLOPS)
    X16, Y16 = X.to(torch.bfloat16), Y.to(torch.bfloat16)
    r["bf16_ms"] = time_ms(lambda: cuda_ops.gaussian_kernel_block(X16, Y16, xn, yn, g), reps)
    r["bf16_bound_ms"], _ = bound_ms(2 * (m * d + n * d) + 4 * (m + n + m * n),
                                     2 * m * n * d + 6 * m * n, PEAK_BF16_FLOPS)
    grid = r["grid"] = cuda_ops.gaussian_kernel_block_grid(m, n, d, False, X.device)
    log(f"  gaussian_kernel_block {label} f32 {m}x{n}x{d}: {r['ms']:.3f} ms a call, "
        f"{r['device_ms']:.3f} ms on the device (plain "
        f"{r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by "
        f"{r['bound_by']}); bf16 operands: {r['bf16_ms']:.3f} ms (bf16 bound "
        f"{r['bf16_bound_ms']:.3f}); grid {grid['tiles']} tiles x "
        f"{grid['splits']} feature chunks, {grid_line(grid)}")
    return r


def phase_cifar_kernels(cuda_ops, cuda_images, fusion, gen):
    """The CIFAR slice's kernels at its shapes: the Gaussian kernel block at
    the three shapes of the route (one train block against all 50,000
    standardized training rows and against the 12,500 test rows, each apply;
    a diagonal block of the pre-pass, full and ragged), the residual of one
    sweep step, and the convolution of one row chunk of images."""
    dev = torch.device("cuda")
    m, n, d, k, g = CIFAR_N, CIFAR_BLOCK, CIFAR_D, CIFAR_K, CIFAR_GAMMA
    X = torch.randn((m, d), generator=gen, device=dev)  # standardized features
    xn = (X * X).sum(1)
    Y, yn = X[2 * n:3 * n], xn[2 * n:3 * n]
    W = torch.randn((m, k), generator=gen, device=dev) * 0.01
    Xt = torch.randn((CIFAR_TEST, d), generator=gen, device=dev)
    xtn = (Xt * Xt).sum(1)
    shapes = cifar_gaussian_shapes(X, xn, Xt, xtn)
    per_shape = {label: gaussian_shape(cuda_ops, label, *args)
                 for label, args in shapes.items()}
    results = {"gaussian_kernel_block": dict(per_shape["train apply"], shapes=per_shape)}
    grid = per_shape["diagonal"]["grid"]
    check("gaussian_kernel_block's diagonal grid fills one wave of resident blocks",
          grid["waves"] >= 0.95, f"{grid['blocks']} blocks, {grid['waves']:.3f} waves")
    for label, dtype in (("f32", torch.float32), ("bf16 operands", torch.bfloat16)):
        # Errors relative to the scale of the sums, max over entries of
        # K^T |W|: 50,000 f32 terms summed in other orders.
        want = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g, compute_dtype=dtype)
        got = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g, compute_dtype=dtype)
        again = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g, compute_dtype=dtype)
        want_r = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g, compute_dtype=dtype)
        scale = (want.T @ W.abs()).max().item()
        torch.cuda.synchronize()
        err = (got - want_r).abs().max().item()
        check(f"gaussian_resid_block {label} X {m}x{d}, Y {n}x{d}, W {m}x{k}",
              err <= 1e-4 * scale and torch.equal(got, again),
              f"max_abs_err {err:.3e} ({err / scale:.2e} of scale), tol 1e-4 of scale, "
              f"the same bits on a second call")
        if label == "f32":
            results["gaussian_resid_block"] = dict(max_abs_err=err)
        del got, again, want, want_r
    xyn = xn[:, None] + yn[None, :]
    r = results["gaussian_resid_block"]
    r["ms"] = time_ms(lambda: cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g), 10)
    r["library_ms"] = time_ms(
        lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_().T @ W, 10)
    r["bound_ms"], r["bound_by"] = bound_ms(
        4 * (m * d + n * d + m + n + m * k + n * k), 2 * m * n * d + 6 * m * n + 2 * m * n * k,
        PEAK_F32_FLOPS)
    r["device_ms"] = device_ms(lambda: cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g), 10)
    X16, Y16 = X.to(torch.bfloat16), Y.to(torch.bfloat16)
    bf16_ms = r["bf16_ms"] = time_ms(
        lambda: cuda_ops.gaussian_resid_block(X16, Y16, xn, yn, W, g), 5)
    r["bf16_library_ms"] = time_ms(
        lambda: bf16_mm(X16, Y16.T, xyn, beta=-g, alpha=2 * g).exp_().T @ W, 5)
    r["bf16_bound_ms"], _ = bound_ms(
        2 * (m * d + n * d) + 4 * (m + n + m * k + n * k),
        2 * m * n * d + 6 * m * n + 2 * m * n * k, PEAK_BF16_FLOPS)
    grid = r["grid"] = cuda_ops.gaussian_resid_block_grid(m, n, d, k, False, dev)
    log(f"  gaussian_resid_block f32: {r['ms']:.3f} ms a call, {r['device_ms']:.3f} ms on the "
        f"device (plain {r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound "
        f"{r['bound_ms']:.3f} by {r['bound_by']}); bf16 operands: {bf16_ms:.3f} ms (library "
        f"{r['bf16_library_ms']:.3f}, bf16 bound {r['bf16_bound_ms']:.3f}); grid "
        f"{grid['tiles']} column tiles x {grid['splits']} row chunks of "
        f"{grid['chunk_tiles'][0]}-{grid['chunk_tiles'][1]} row tiles, {grid['label_tiles']} "
        f"{grid['ktile']}-wide label pass, {grid['smem_bytes']} bytes of shared memory, "
        f"{grid_line(grid)}")
    check("gaussian_resid_block spills nothing and fills whole waves",
          grid["local_bytes"] == 0 and grid["waves"] >= 0.95,
          f"{grid['local_bytes']} local bytes a thread, {grid['waves']:.3f} waves")
    del X, Y, W, X16, Y16, Xt, xtn, xyn, xn, yn, shapes
    torch.cuda.empty_cache()

    # conv_featurize: one row chunk of the featurization, CIFAR images
    # (pixels in [0, 255]), 100 unit filters of 6 x 6 x 3, whitening means.
    c = _conv_chunk_rows(fusion)
    images, filters, means = conv_operands(c, 32, gen, whitened=True)
    results["conv_featurize"] = conv_shape(cuda_images, "whitened 32 x 32", images, filters,
                                           means, main_form=True)
    del images, filters, means
    torch.cuda.empty_cache()
    return results


def conv_operands(c, size, gen, whitened):
    """``c`` images of ``size`` x ``size`` x 3 (pixels in [0, 255]), 100
    unit filters of 6 x 6 x 3 and, when ``whitened``, whitening means."""
    dev = torch.device("cuda")
    images = torch.rand((c, size, size, 3), generator=gen, device=dev) * 255
    filters = torch.randn((CIFAR_FILTERS, 108), generator=gen, device=dev)
    filters /= filters.norm(dim=1, keepdim=True)
    means = torch.randn((108,), generator=gen, device=dev) * 0.1 if whitened else None
    return images, filters, means


def conv_shape(cuda_images, label, images, filters, means, main_form=False):
    """conv_featurize at one operand form against its plain version (1e-4
    of the scale of the sums), the guard's verdict, its grid, and the
    kernel, plain version, library yardstick (``F.unfold`` + normalise +
    ``matmul``), the product alone on cuBLAS and the bound in ms. The main
    form (the RandomPatchCifarKernel chunk) must also fill its last round
    of tiles; every form must spill nothing."""
    c, size, _, _ = images.shape
    p, (f, dp) = 6, filters.shape
    out = size - p + 1

    def conv():
        return cuda_images.conv_featurize(images, filters, means, patch_size=p)

    def plain():
        return cuda_images.conv_featurize_ref(images, filters, means, patch_size=p)

    def centred(cols):
        cols = cuda_images.normalize_patch_rows(cols, 10.0)
        return cols if means is None else cols - means

    def library():  # F.unfold (NCHW im2col) + normalise + matmul
        cols = torch.nn.functional.unfold(images.permute(0, 3, 1, 2), p)  # (c, 3*36, out^2)
        cols = cols.view(c, 3, p, p, -1).permute(0, 4, 2, 3, 1).reshape(c, -1, dp)
        return (centred(cols) @ filters.T).view(c, out, out, f)

    name = f"conv_featurize {label} ({c} images of {size} x {size} x 3, filters {f}x{dp}, " \
           f"{'whitening means' if means is not None else 'no whitener'})"
    check(f"{name}: the guard takes it", cuda_images.conv_featurize_ok(images, filters),
          "conv_featurize_ok")
    got, want = conv(), plain()
    patches = centred(cuda_images.im2col(images, p))
    scale = (patches.abs() @ filters.abs().T).max().item()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lib_err = (library() - want).abs().max().item()
    check(name, err <= 1e-4 * scale and lib_err <= 1e-4 * scale,
          f"max_abs_err {err:.3e} ({err / scale:.2e} of scale), tol 1e-4 of scale; "
          f"the library yardstick's {lib_err:.3e}")
    del got, want
    npix = c * out * out
    r = dict(max_abs_err=err, images=c, image_size=size, whitened=means is not None)
    r["ms"] = time_ms(conv, 10)
    r["device_ms"] = device_ms(conv, 10)
    r["plain_ms"] = time_ms(plain, 5)
    r["library_ms"] = time_ms(library, 5)
    # The product alone on cuBLAS FP32: the normalised patch matrix made
    # before timing, times the filters.
    patches = patches.view(npix, dp)
    r["gemm_ms"] = time_ms(lambda: torch.matmul(patches, filters.T), 10)
    del patches
    r["bound_ms"], r["bound_by"] = bound_ms(
        4 * (c * size * size * 3 + f * dp + (0 if means is None else dp) + npix * f),
        2 * npix * dp * f + 5 * npix * dp,  # filter product + patch mean, variance, scaling
        PEAK_F32_FLOPS,
    )
    grid = r["grid"] = cuda_images.conv_featurize_grid(c, size, size, 3, p, f, images.device)
    log(f"  conv_featurize {label} f32 ({c} images): {r['ms']:.3f} ms a call, "
        f"{r['device_ms']:.3f} ms on the device (plain {r['plain_ms']:.3f}, library "
        f"{r['library_ms']:.3f}, the product alone on cuBLAS {r['gemm_ms']:.3f}, bound "
        f"{r['bound_ms']:.3f} by {r['bound_by']}); grid {grid['tiles']} pixel tiles, "
        f"{grid['ktile']}-wide filter tile ({100 * grid['masked']:.1f}% masked), "
        f"{grid['smem_bytes']} bytes of shared memory, "
        f"{'16-byte' if grid['vec_stores'] else 'element'} stores, {grid['fill']:.3f} of the "
        f"blocks' rounds filled, {grid_line(grid)}")
    if main_form:
        check("conv_featurize spills nothing and fills its last round of tiles",
              grid["local_bytes"] == 0 and grid["fill"] >= 0.95 and grid["waves"] >= 0.95,
              f"{grid['local_bytes']} local bytes a thread, {grid['fill']:.3f} of the rounds, "
              f"{grid['waves']:.3f} waves")
    else:
        check(f"conv_featurize {label} spills nothing", grid["local_bytes"] == 0,
              f"{grid['local_bytes']} local bytes a thread")
    return r


def phase_new_forms(cuda_ops, cuda_images, fusion, gen, results):
    """Phase 1's kernel forms of phase 17's routes: ``conv_featurize``
    without a whitener (RandomCifar's Gaussian filters) on a 32 x 32 row
    chunk and with one on a 24 x 24 chunk of augmented crops (each chunk as
    the fused featurizer cuts it), and ``gaussian_kernel_block`` at
    Nyström's shapes, K(X, L) for 50,000 x 2,048 and the square K(L, L) for
    2,048 x 2,048 (its clamp checked), on standard normal rows (the
    standardised features' scale). Adds them under each row's ``shapes``."""
    conv = results["conv_featurize"].setdefault("shapes", {})
    for label, size, row_bytes, whitened in (
            ("no whitener 32 x 32", 32, CONV_ROW_BYTES, False),
            ("whitened 24 x 24", AUG_SIZE, AUG_ROW_BYTES, True)):
        images, filters, means = conv_operands(_conv_chunk_rows(fusion, row_bytes), size, gen,
                                               whitened)
        conv[label] = conv_shape(cuda_images, label, images, filters, means)
        del images, filters, means
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    X = torch.randn((CIFAR_N, CIFAR_D), generator=gen, device=dev)
    xn = (X * X).sum(1)
    L, ln = X[:NYS_M], xn[:NYS_M]
    shapes = results["gaussian_kernel_block"]["shapes"]
    shapes["nystrom K(X, L)"] = gaussian_shape(cuda_ops, "nystrom K(X, L)", X, L, xn, ln, False)
    shapes["nystrom K(L, L)"] = gaussian_shape(cuda_ops, "nystrom K(L, L)", L, L, ln, ln, True)
    del X, xn, L, ln
    torch.cuda.empty_cache()


def cifar_config(cifar):
    """RandomPatchCifarKernel at full width: 50,000 images, 100 filters,
    KRR block 512, 1 epoch."""
    return cifar.CifarConfig(synthetic_n=CIFAR_N, num_filters=CIFAR_FILTERS,
                             block_size=CIFAR_BLOCK, kernel_gamma=CIFAR_GAMMA, num_epochs=1)


def cifar_launches(cuda_ops, fusion):
    """Each wrapper's launches in one full-width CIFAR fit and train and
    test apply."""
    expected = {name: 0 for name in cuda_ops.launches}
    expected.update(
        conv_featurize=2 * _conv_launches(fusion, CIFAR_N) + _conv_launches(fusion, CIFAR_TEST),
        gaussian_kernel_block=3 * CIFAR_BLOCKS,  # diagonal pre-pass, train apply, test apply
        gaussian_resid_block=CIFAR_BLOCKS,  # one per sweep step, 1 epoch
    )
    return expected


def phase_cifar(cuda_ops, fusion):
    """RandomPatchCifarKernel: small on the card against the CPU plain run,
    then at full width through its entry point, launches counted from 0."""
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    small = cifar.CifarConfig(synthetic_n=640, num_filters=32, whitener_size=400,
                              block_size=256)
    errs = {}
    for device in ("cuda", "cpu"):
        PipelineEnv.get_or_create().reset()
        run = cifar.run_random_patch_cifar_kernel(small, device=device)
        errs[device] = (run.train_eval.total_error, run.test_eval.total_error)
    PipelineEnv.get_or_create().reset()
    check("small RandomPatchCifarKernel (640 images, 32 filters, 3 blocks), card against "
          "CPU plain versions", errs["cuda"] == errs["cpu"],
          f"train/test error cuda {errs['cuda']}, cpu {errs['cpu']} (equal)")

    config = cifar_config(cifar)
    expected = cifar_launches(cuda_ops, fusion)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = cifar.run_random_patch_cifar_kernel(config, device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    log(f"  {CIFAR}, n={CIFAR_N}, test {CIFAR_TEST}, d={CIFAR_D}, block {CIFAR_BLOCK} "
        f"({CIFAR_BLOCKS} blocks), 1 epoch: train error {100 * train_err:.3f}%, test error "
        f"{100 * test_err:.3f}%, fit {result.fit_seconds:.3f} s, apply (train + test) "
        f"{result.apply_seconds:.3f} s, run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    check(f"{CIFAR} launches", same_launches(counts, expected), f"{counts}, expected {expected}")
    check(f"{CIFAR} metrics",
          0.0 <= train_err <= 1.0 and 0.0 <= test_err < 0.9
          and result.train_eval.total == CIFAR_N and result.test_eval.total == CIFAR_TEST,
          "errors in [0, 1], test error below chance (90%), every image scored")
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err,
                        test_error=test_err), result, config


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def function_name(demangled):
    """A demangled kernel name's bare function name: without its return
    type, namespaces, template arguments and parameter list."""
    depth, bare = 0, []
    for ch in without_parameters(demangled):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            bare.append(ch)
    words = "".join(bare).split("::")[-1].split()
    return words[-1] if words else ""


# The kernel functions of the CIFAR route's wrappers (csrc/*.cu): the first
# runs once a call, the second once more where a call splits its reduction
# into chunks (gaussian_kernel_block's features, gaussian_resid_block's
# rows). No other port kernel runs on this route (phase 6's counts).
CIFAR_FUNCTIONS = {
    "conv_featurize": ("conv_featurize_kernel",),
    "gaussian_kernel_block": ("gauss_kernel", "sum_epilogue_kernel"),
    "gaussian_resid_block": ("resid_kernel", "sum_partials_kernel"),
}


def cifar_kernel_calls(cuda_ops):
    """The CIFAR route's Gaussian kernel calls, wrapper -> whether each call
    splits its reduction (a second kernel), from the route's shapes: every
    KRR block (97 of 512 rows, the last of 336) once in the diagonal
    pre-pass, the train apply and the test apply of
    ``gaussian_kernel_block``, and once in the sweep's
    ``gaussian_resid_block``."""
    dev = torch.device("cuda")
    sizes = [min(CIFAR_BLOCK, CIFAR_N - b * CIFAR_BLOCK) for b in range(CIFAR_BLOCKS)]
    gauss, resid = [], []
    for nb in sizes:
        for m, n in ((nb, nb), (CIFAR_N, nb), (CIFAR_TEST, nb)):
            grid = cuda_ops.gaussian_kernel_block_grid(m, n, CIFAR_D, False, dev)
            gauss.append(grid["splits"] > 1)
        grid = cuda_ops.gaussian_resid_block_grid(CIFAR_N, nb, CIFAR_D, CIFAR_K, False, dev)
        resid.append(grid["splits"] > 1)
    return {"gaussian_kernel_block": gauss, "gaussian_resid_block": resid}


def cifar_profile():
    """The profiled half of phase 7, run in a process of its own
    (``python3 chip_smoke.py --cifar-profile``): one full-width CIFAR fit
    and apply to warm up, then a second under ``torch.profiler``, the
    launch counts set to 0 just before it. Prints one JSON line: the
    route's launches, the traced device time and count of every kernel
    name, and the fit's and the fit + apply's wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    config = cifar_config(cifar)
    dev = torch.device("cuda")
    PipelineEnv.get_or_create().reset()
    cifar.run_random_patch_cifar_kernel(config, device="cuda")
    PipelineEnv.get_or_create().reset()
    pipeline, train, test = cifar.build_pipeline(config, dev)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fitted = pipeline.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fitted.apply(train.data)
        fitted.apply(test.data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cuda_ops.launches)
    PipelineEnv.get_or_create().reset()
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    print(json.dumps(dict(launches=launches, rows=rows, fit_seconds=fit_s,
                          fit_apply_seconds=wall)))
    return 0


def check_cifar_profile(cuda_ops, fusion, prof):
    """Hold ``cifar_profile``'s output to the route: its launch counts to
    phase 6's, and each port kernel function's traced count to the
    launches that the counters and the route's shapes say it made. Logs
    the device's busy share and the largest kernels; returns the busy
    device ms and the device ms of each CIFAR wrapper's kernels."""
    launches, wall = prof["launches"], prof["fit_apply_seconds"]
    expected = cifar_launches(cuda_ops, fusion)
    check("profiled CIFAR fit and apply launches", same_launches(launches, expected),
          f"{launches}, expected {expected}")
    traced = {}
    for key, _, count in prof["rows"]:
        name = function_name(key)
        traced[name] = traced.get(name, 0) + count
    splits = cifar_kernel_calls(cuda_ops)
    for wrapper, functions in CIFAR_FUNCTIONS.items():
        calls = splits.get(wrapper, [False] * launches[wrapper])
        want = {functions[0]: launches[wrapper]}
        if len(functions) > 1:
            want[functions[1]] = sum(calls)
        got = {f: traced.get(f, 0) for f in functions}
        check(f"profile traced every {wrapper} launch",
              len(calls) == launches[wrapper] and got == want,
              f"traced {got}, the route launched {want} ({launches[wrapper]} calls, "
              f"{sum(calls)} with a second kernel)")
    rows = sorted(((key, ms, count) for key, ms, count in prof["rows"] if ms > 0),
                  key=lambda row: -row[1])
    busy_ms = sum(row[1] for row in rows)
    log(f"  profiled warm fit {prof['fit_seconds']:.3f} s, fit + apply {wall:.3f} s (a fresh "
        f"process); device busy {busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f}% of fit + "
        f"apply)")
    for name, ms, count in rows[:14]:
        log(f"    {ms:10.3f} ms  {count:6d}x  {name[:90]}")
    by_wrapper = {wrapper: sum(ms for key, ms, _ in rows if function_name(key) in functions)
                  for wrapper, functions in CIFAR_FUNCTIONS.items()}
    log(f"  device ms by port wrapper: {by_wrapper}")
    return busy_ms, by_wrapper


def phase_cifar_time(cuda_ops, fusion, result, config):
    """Where the full-width CIFAR fit's time goes. (a) The Gauss-Seidel
    sweep on the run's own train features, timed as it is (each step's
    solve reads its rescue decision on the host: one sync a step) and with
    the solve's acceptance check taken out (the same Cholesky solve, no
    sync), in turns; the two give the same weights. (b) A warm fit and
    apply under ``torch.profiler`` in a fresh process (``cifar_profile``):
    device time by name and the device's busy share of the wall time. Each
    port kernel's traced launches must equal what the route's launch
    counters and shapes say it launched (``CIFAR_FUNCTIONS``,
    ``cifar_kernel_calls``): a profile that lost records fails the phase."""
    from keystone_tpu_torch.ops.learning import kernel

    (mapper,) = [op for op in result.fitted.transformer_graph.operators.values()
                 if isinstance(op, kernel.KernelBlockLinearMapper)]
    kt, bs, lam = mapper.kernel_transformer, mapper.block_size, float(config.lam)
    n = kt.n_train
    nb = -(-n // bs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    labels = torch.randint(0, CIFAR_K, (n,), generator=gen, device=dev)
    Y = 2.0 * torch.nn.functional.one_hot(labels, CIFAR_K).float() - 1.0
    grams, chols = kernel._diag_factor_prepass(kt, lam, bs, nb)
    order = np.arange(nb)
    sweep = kernel._Sweep(kt, Y, bs)
    with_sync = kernel._solve_psd

    def without_sync(gram, rhs, lam, chol=None):
        return torch.cholesky_solve(rhs, chol)

    times, stacks = {"with sync": [], "without": []}, {}
    for label in ("with sync", "without", "without", "with sync"):
        kernel._solve_psd = with_sync if label == "with sync" else without_sync
        try:
            stack = torch.zeros((nb, bs, CIFAR_K), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stacks[label] = sweep.run(order, grams, chols, lam, stack)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
        finally:
            kernel._solve_psd = with_sync
    sync_s, free_s = (statistics.median(times[k]) for k in ("with sync", "without"))
    log(f"  sweep of {nb} steps: {sync_s:.4f} s with the per-step host sync, {free_s:.4f} s "
        f"without (runs {times}); the syncs cost {1e3 * (sync_s - free_s) / nb:.3f} ms a step")
    check("sweep without the host sync gives the same weights",
          torch.equal(stacks["with sync"], stacks["without"]), "bitwise equal")
    del grams, chols, stacks, sweep, Y
    torch.cuda.empty_cache()

    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--cifar-profile"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise RuntimeError(f"the CIFAR profile's process failed (rc {child.returncode}):\n"
                           f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    fit_s, wall = prof["fit_seconds"], prof["fit_apply_seconds"]
    busy_ms, by_wrapper = check_cifar_profile(cuda_ops, fusion, prof)
    return dict(sweep_seconds_with_sync=sync_s, sweep_seconds_without_sync=free_s,
                profiled_fit_seconds=fit_s, profiled_fit_apply_seconds=wall,
                device_busy_ms=busy_ms, device_ms_by_wrapper=by_wrapper)


def amazon_rows(n, d, nnz, k, seed, w_true):
    """Padded-COO rows as the reference's bench row makes them
    (bench.py:1234-1243: ``nnz`` uniform column indices a row, sorted, and
    standard normal values; duplicates within a row stay), with labels from
    a planted sparse linear model plus noise, so that accuracy means
    something. Returns (indices, values, class labels, ±1 one-hot Y)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    idx.sort(axis=1)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    score = (vals * w_true[idx]).sum(axis=1) + 0.5 * rng.normal(size=n).astype(np.float32)
    labels = (score > 0).astype(np.int64)
    Y = 2.0 * np.eye(k, dtype=np.float32)[labels] - 1.0
    return idx, vals, labels, Y


def planted_model(d, seed):
    """A sparse true model: 5% of the features carry a standard normal weight."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=d) * (rng.random(d) < 0.05)).astype(np.float32)


def _fitted_mapper(fitted):
    from keystone_tpu_torch.ops.learning.linear import SparseLinearMapper

    (mapper,) = [op for op in fitted.transformer_graph.operators.values()
                 if isinstance(op, SparseLinearMapper)]
    return mapper


def _ridge_loss(mapper, idx, vals, Y, lam, n):
    """½‖XW + b − Y‖²/n + ½λ(‖W‖² + ‖b‖²): the objective the sparse fits
    minimise (the intercept is the append-ones lane's weight)."""
    from keystone_tpu_torch.ops.sparse import sparse_matmul

    r = sparse_matmul(idx, vals, mapper.x) + mapper.b_opt - Y
    reg = (mapper.x * mapper.x).sum() + (mapper.b_opt * mapper.b_opt).sum()
    return float(0.5 * (r * r).sum() / n + 0.5 * lam * reg)


def _accuracy(pred, labels):
    return float((pred.array[: pred.n].argmax(dim=1) == labels).float().mean())


def _sparse_fit(cuda_ops, est, train, labels):
    """Fit ``est`` through a Sparsify pipeline, launches counted from 0.
    Returns (fitted pipeline, fit seconds, launches, peak allocated bytes)."""
    from keystone_tpu_torch.ops.sparse import Sparsify
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    fitted = Sparsify().and_then(est, train, labels).fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    return fitted, fit_s, counts, peak


def phase_sparse_small(cuda_ops):
    """The sparse slice small (n 4,096, d 1,000, 16 active a row, chunk 512)
    on the card against its plain run on the CPU: the same weights within
    1e-4 relative (float32 sums in other orders) and the same final loss
    within 1e-5 relative, for the gather engine and the gram engine with
    f32 and bf16 slabs."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2

    n, d, nnz, k = 4096, 1000, 16, AMAZON_K
    idx, vals, _, Y = amazon_rows(n, d, nnz, k, seed=11, w_true=planted_model(d, 12))
    for engine in (dict(solver="gather"), dict(solver="gram", gram_dtype="f32"),
                   dict(solver="gram", gram_dtype="bf16")):
        runs = {}
        for where, device in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
            t = [torch.from_numpy(a).to(device) for a in (idx, vals, Y)]
            est = SparseLBFGSwithL2(lam=AMAZON_LAM, num_iterations=AMAZON_ITERS,
                                    num_features=d, gram_chunk_rows=512, **engine)
            fitted, *_ = _sparse_fit(cuda_ops, est, Dataset({"indices": t[0], "values": t[1]},
                                                            n=n), Dataset(t[2]))
            mapper = _fitted_mapper(fitted)
            W = torch.cat([mapper.x, mapper.b_opt[None]]).cpu()
            runs[where] = (W, _ridge_loss(mapper, t[0], t[1], t[2], AMAZON_LAM, n))
        (Wg, lg), (Wc, lc) = runs["card"], runs["cpu"]
        rel = float((Wg - Wc).norm() / Wc.norm())
        check(f"small sparse {engine}, card against CPU plain versions",
              rel <= 1e-4 and abs(lg - lc) <= 1e-5 * abs(lc),
              f"weights relative Frobenius {rel:.2e} (tol 1e-4), final loss {lg:.7f} on the "
              f"card, {lc:.7f} on the CPU (tol 1e-5 relative)")


def phase_sparse(cuda_ops):
    """The sparse slice at the Amazon geometry through four engines, then the
    streamed fit whole and segmented."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2

    dev = torch.device("cuda")
    n, d, nnz, k = AMAZON_N, AMAZON_D, AMAZON_NNZ, AMAZON_K
    n_test = n // 4
    t0 = time.perf_counter()
    w_true = planted_model(d, 2)
    rows = {name: [torch.from_numpy(a).to(dev) for a in amazon_rows(m, d, nnz, k, seed, w_true)]
            for name, m, seed in (("train", n, 1), ("test", n_test, 3))}
    train = Dataset({"indices": rows["train"][0], "values": rows["train"][1]}, n=n)
    test = Dataset({"indices": rows["test"][0], "values": rows["test"][1]}, n=n_test)
    labels = Dataset(rows["train"][3])
    log(f"  data: {n} train and {n_test} test rows of d={d}, {nnz} active a row, made in "
        f"{time.perf_counter() - t0:.3f} s")
    engines = {
        "gather": dict(solver="gather"),
        "gram bf16": dict(solver="gram", gram_dtype="bf16"),
        "gram f32": dict(solver="gram", gram_dtype="f32"),
        "gram compressed int16+bf16": dict(solver="gram", compress="int16_bf16"),
    }
    models, report, sparse_counts = {}, {}, None
    for name, kw in engines.items():
        est = SparseLBFGSwithL2(lam=AMAZON_LAM, num_iterations=AMAZON_ITERS, num_features=d,
                                gram_chunk_rows=AMAZON_CHUNK, **kw)
        fitted, fit_s, counts, peak = _sparse_fit(cuda_ops, est, train, labels)
        t0 = time.perf_counter()
        train_pred, test_pred = fitted.apply(train), fitted.apply(test)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        models[name] = _fitted_mapper(fitted)
        acc = (_accuracy(train_pred, rows["train"][2]), _accuracy(test_pred, rows["test"][2]))
        report[name] = dict(fit_seconds=fit_s, apply_seconds=apply_s, peak_allocated_bytes=peak,
                            train_accuracy=acc[0], test_accuracy=acc[1])
        log(f"  {name}: fit {fit_s:.3f} s, apply (train + test) {apply_s:.3f} s, peak allocated "
            f"{peak / 2**30:.2f} GiB, accuracy train {100 * acc[0]:.3f}% test "
            f"{100 * acc[1]:.3f}%, launches {counts}")
        expected = {kernel: 0 for kernel in cuda_ops.launches}
        if kw["solver"] == "gram":
            expected["gram_corr_sym_acc"] = AMAZON_CHUNKS
        check(f"{name} launches", same_launches(counts, expected), f"{counts}, expected {expected}")
        check(f"{name} accuracy", acc[0] > 0.75 and acc[1] > 0.75,
              "train and test accuracy above 75% (chance is 50%; the labels follow a planted "
              "sparse model with noise)")
        if name == "gram bf16":
            sparse_counts = counts
    base = models["gather"]
    deltas = {name: max(float((m.x - base.x).abs().max()), float((m.b_opt - base.b_opt).abs().max()))
              for name, m in models.items() if name != "gather"}
    log(f"  engines_max_abs_model_delta against gather: {deltas}")
    check("gram engines agree with the gather engine",
          all(v <= 5e-3 * float(base.x.abs().max()) for v in deltas.values()),
          f"{deltas} (each within 5e-3 of the gather model's largest weight "
          f"{float(base.x.abs().max()):.4f}: bf16 slabs quantize the data)")
    comp, b16 = models["gram compressed int16+bf16"], models["gram bf16"]
    check("compressed engine has the bits of the bf16 gram engine",
          torch.equal(comp.x, b16.x) and torch.equal(comp.b_opt, b16.b_opt), "bitwise equal")
    report["engines_max_abs_model_delta"] = deltas
    amazon = dict(rows=rows, train=train, test=test, labels=labels, gather=base,
                  gather_accuracy=(report["gather"]["train_accuracy"],
                                   report["gather"]["test_accuracy"]),
                  gram_bf16=_w1(models["gram bf16"]), w_true=w_true,
                  # Phase 23(c) holds the selector's fits to these.
                  by_engine={name: _w1(m) for name, m in models.items()})
    del models, comp, b16
    torch.cuda.empty_cache()
    report["streamed"] = phase_sparse_streamed(cuda_ops, w_true)
    return sparse_counts, report, amazon


def _clamped_chunk(cid, idx_t, val_t, y_t):
    """Resident chunk ``cid``; ids past the end slice the last chunk, whose
    values and labels the segmented fold zeroes."""
    cid = min(cid, idx_t.shape[0] - 1)
    return idx_t[cid], val_t[cid], y_t[cid]


def phase_sparse_streamed(cuda_ops, w_true):
    """``run_lbfgs_gram_streamed`` over 8 resident chunks of 65,536 rows
    (made on the card: 82 uniform indices a row and the intercept lane,
    standard normal values, planted-model labels), bf16 slabs, folded whole
    and in segments of 3 chunks: the same bits."""
    from keystone_tpu_torch.ops.learning.lbfgs import run_lbfgs_gram_streamed

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    nc, c, d, nnz, k = STREAM_CHUNKS, AMAZON_CHUNK, AMAZON_D, AMAZON_NNZ, AMAZON_K
    idx = torch.randint(0, d, (nc, c, nnz), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.cat([idx.sort(dim=2).values,
                     torch.full((nc, c, 1), d, dtype=torch.int32, device=dev)], dim=2)
    vals = torch.randn((nc, c, nnz + 1), generator=gen, device=dev)
    vals[:, :, nnz] = 1.0
    w = torch.from_numpy(w_true).to(dev)
    score = (vals[:, :, :nnz] * w[idx[:, :, :nnz].long()]).sum(dim=2)
    score += 0.5 * torch.randn(score.shape, generator=gen, device=dev)
    Y = 2.0 * torch.nn.functional.one_hot((score > 0).long(), k).float() - 1.0
    n = nc * c
    runs = {}
    for label, seg in (("whole", None), (f"segments of {STREAM_SEG}", STREAM_SEG)):
        cuda_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W, loss = run_lbfgs_gram_streamed(
            _clamped_chunk, nc, d + 1, k, lam=AMAZON_LAM, num_iterations=AMAZON_ITERS, n=n,
            val_dtype=torch.bfloat16, operands=(idx, vals, Y), max_chunks_per_dispatch=seg,
        )
        torch.cuda.synchronize()
        runs[label] = dict(W=W, loss=loss, seconds=time.perf_counter() - t0,
                           launches=cuda_ops.launches["gram_corr_sym_acc"])
    whole, segmented = runs.values()
    log(f"  streamed fit, n={n} ({nc} chunks), d={d + 1}, bf16 slabs: whole "
        f"{whole['seconds']:.3f} s ({whole['launches']} launches), segments of {STREAM_SEG} "
        f"{segmented['seconds']:.3f} s ({segmented['launches']} launches), final loss "
        f"{float(whole['loss']):.7f}")
    check("segmented streamed fit has the bits of the whole one",
          torch.equal(whole["W"], segmented["W"]) and torch.equal(whole["loss"], segmented["loss"])
          and whole["launches"] == nc and segmented["launches"] == -(-nc // STREAM_SEG) * STREAM_SEG,
          f"bitwise equal weights and loss; launches {whole['launches']} and "
          f"{segmented['launches']} (a chunk id past the end folds zeros)")
    return {label: dict(seconds=r["seconds"], launches=r["launches"], final_loss=float(r["loss"]))
            for label, r in runs.items()}


def _w1(mapper):
    return torch.cat([mapper.x, mapper.b_opt[None]])


def _dense_objective(mapper, A, Y, lam, n):
    """½‖f(A) − Y‖²/n + ½λ‖x‖² of a fitted dense model: the same formula for
    the card's and the CPU's fit of one problem."""
    r = mapper.apply(A) - Y
    return float(0.5 * (r * r).sum() / n + 0.5 * lam * (mapper.x * mapper.x).sum())


def phase_sketch_small(cuda_ops):
    """The sketched tier small on the card against its plain run on the CPU,
    the port's own draws (made on the CPU, the same on both): the sparse,
    compressed and SRHT fits of phase 8's small rows (n 4,096, d 1,000, 16
    active a row), and SRHT, IHS and the sketch-and-solve estimator on a
    dense 4,096 x 256 problem. Weights within 1e-4 relative (float32 sums
    in other orders; on the card the gradient operand's and the dense
    segment sums' ``index_add_`` add in atomic order), the final ridge
    objective within 1e-5 relative."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.linear import SketchedLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.sketch import (
        IterativeHessianSketch,
        SketchedLeastSquares,
    )

    n, d, nnz, k, lam = 4096, 1000, 16, AMAZON_K, AMAZON_LAM
    idx, vals, _, Y = amazon_rows(n, d, nnz, k, seed=11, w_true=planted_model(d, 12))
    rng = np.random.default_rng(13)
    A = rng.normal(size=(n, 256)).astype(np.float32)
    score = A @ rng.normal(size=256).astype(np.float32) + 0.5 * rng.normal(size=n)
    YA = (2.0 * np.eye(k, dtype=np.float32)[(score > 0).astype(int)] - 1.0)
    # IHS at its default m = 4(d+1): at 2(d+1) this problem's first step
    # raises the gradient norm and the guard returns the zero model, which
    # would compare nothing.
    m = 2 * (d + 1)
    sparse_fits = {
        "IHS": lambda: IterativeHessianSketch(lam=lam, outer_iters=SKETCH_OUTER,
                                              seed=SKETCH_SEED, num_features=d, chunk_rows=512),
        "IHS compressed": lambda: IterativeHessianSketch(
            lam=lam, outer_iters=SKETCH_OUTER, seed=SKETCH_SEED, num_features=d,
            chunk_rows=512, compress="int16_bf16"),
        "SRHT": lambda: SketchedLeastSquares(lam=lam, sketch_size=m, pcg_iters=SKETCH_PCG,
                                             seed=SKETCH_SEED, num_features=d, chunk_rows=512),
    }
    dense_fits = {
        "dense SRHT": lambda: SketchedLeastSquares(lam=lam, sketch_factor=2,
                                                   pcg_iters=SKETCH_PCG, seed=SKETCH_SEED,
                                                   chunk_rows=512),
        "dense IHS": lambda: IterativeHessianSketch(lam=lam, outer_iters=SKETCH_OUTER,
                                                    seed=SKETCH_SEED),
        "sketch-and-solve estimator": lambda: SketchedLeastSquaresEstimator(
            lam=lam, seed=SKETCH_SEED),
    }
    for name, make in {**sparse_fits, **dense_fits}.items():
        runs = {}
        for where, device in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
            if name in sparse_fits:
                t = [torch.from_numpy(a).to(device) for a in (idx, vals, Y)]
                data, labels = Dataset({"indices": t[0], "values": t[1]}, n=n), Dataset(t[2])
            else:
                t = [torch.from_numpy(a).to(device) for a in (A, YA)]
                data, labels = Dataset(t[0]), Dataset(t[1])
            est = make()
            model = est.fit(data, labels)
            if name in sparse_fits:
                obj = _ridge_loss(model, t[0], t[1], t[2], lam, n)
            else:
                obj = _dense_objective(model, t[0], t[1], lam, n)
            runs[where] = (_w1(model).cpu(), obj, getattr(est, "steps", None))
        (Wg, og, sg), (Wc, oc, sc) = runs["card"], runs["cpu"]
        rel = float((Wg - Wc).norm() / Wc.norm())
        check(f"small {name}, card against CPU plain versions",
              rel <= 1e-4 and abs(og - oc) <= 1e-5 * abs(oc) and sg == sc != 0
              and bool(torch.isfinite(Wg).all()),
              f"weights relative Frobenius {rel:.2e} (tol 1e-4), final objective {og:.7f} on "
              f"the card, {oc:.7f} on the CPU (tol 1e-5 relative)"
              + (f", {sg} Newton steps kept on both" if sg is not None else ""))


def phase_sketch(cuda_ops, amazon):
    """The reference's frontier sweep on phase 8's Amazon rows, each fit
    through a Sparsify pipeline with the launch counts set to 0 before it
    and read after; then where one IHS fit's time goes.

    Each IHS fit's fold passes and kept Newton steps are pinned. At m =
    2(d+1) the first step raises the exact gradient norm and the guard
    returns the zero model after 2 passes (the reference does the same on
    this geometry cut to a quarter, CPU runs of both packages); at 4(d+1)
    every step is kept (3 passes), so that fit is the kernel's main path
    and the one the compressed fold is held against."""
    from keystone_tpu_torch.ops.learning.sketch import (
        IterativeHessianSketch,
        SketchedLeastSquares,
    )

    d, lam, n = AMAZON_D, AMAZON_LAM, AMAZON_N
    rows, train, test, labels = (amazon[key] for key in ("rows", "train", "test", "labels"))
    gather = amazon["gather"]
    ihs = dict(lam=lam, outer_iters=SKETCH_OUTER, seed=SKETCH_SEED, num_features=d,
               chunk_rows=AMAZON_CHUNK)  # the estimator's default chunk
    m1, m2 = SKETCH_M, 2 * SKETCH_M
    # name: (estimator, pinned (fold passes, Newton steps kept) or None)
    fits = {
        f"IHS m={m1}": (IterativeHessianSketch(sketch_size=m1, **ihs), (2, 0)),
        f"IHS m={m2}": (IterativeHessianSketch(sketch_size=m2, **ihs), (SKETCH_OUTER,) * 2),
        f"IHS compressed int16+bf16 m={m1}": (IterativeHessianSketch(
            sketch_size=m1, compress="int16_bf16", **ihs), (2, 0)),
        f"IHS compressed int16+bf16 m={m2}": (IterativeHessianSketch(
            sketch_size=m2, compress="int16_bf16", **ihs), (SKETCH_OUTER,) * 2),
        f"SRHT m={m1}": (SketchedLeastSquares(
            lam=lam, sketch_size=m1, pcg_iters=SKETCH_PCG, seed=SKETCH_SEED,
            num_features=d), None),
    }
    gather_obj = _ridge_loss(gather, rows["train"][0], rows["train"][1], rows["train"][3], lam, n)
    log(f"  L-BFGS gather fit (phase 8): accuracy train {100 * amazon['gather_accuracy'][0]:.3f}% "
        f"test {100 * amazon['gather_accuracy'][1]:.3f}%, ridge objective {gather_obj:.7f}")
    report, models, sketch_counts = {"gather_objective": gather_obj}, {}, None
    for name, (est, pinned) in fits.items():
        fitted, fit_s, counts, peak = _sparse_fit(cuda_ops, est, train, labels)
        t0 = time.perf_counter()
        train_pred, test_pred = fitted.apply(train), fitted.apply(test)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        mapper = models[name] = _fitted_mapper(fitted)
        acc = (_accuracy(train_pred, rows["train"][2]), _accuracy(test_pred, rows["test"][2]))
        obj = _ridge_loss(mapper, rows["train"][0], rows["train"][1], rows["train"][3], lam, n)
        delta = float((_w1(mapper) - _w1(gather)).abs().max())
        passes, steps = getattr(est, "passes", None), getattr(est, "steps", None)
        report[name] = dict(fit_seconds=fit_s, apply_seconds=apply_s, peak_allocated_bytes=peak,
                            train_accuracy=acc[0], test_accuracy=acc[1], objective=obj,
                            max_abs_delta_vs_gather=delta, passes=passes, steps=steps,
                            launches=counts)
        log(f"  {name}: fit {fit_s:.3f} s, apply (train + test) {apply_s:.3f} s, peak "
            f"allocated {peak / 2**30:.2f} GiB, accuracy train {100 * acc[0]:.3f}% test "
            f"{100 * acc[1]:.3f}%, ridge objective {obj:.7f}, max |W - W_gather| {delta:.3e}, "
            f"fold passes {passes}, Newton steps kept {steps}, launches {counts}")
        expected = {kernel: 0 for kernel in cuda_ops.launches}
        if pinned is not None:
            check(f"{name} passes and steps", (passes, steps) == pinned,
                  f"{passes} fold passes and {steps} Newton steps kept, expected {pinned[0]} "
                  f"and {pinned[1]}")
            expected["countsketch_scatter"] = AMAZON_CHUNKS * pinned[0]
        check(f"{name} launches", same_launches(counts, expected), f"{counts}, expected {expected}")
        check(f"{name} finiteness", np.isfinite(obj) and bool(torch.isfinite(_w1(mapper)).all()),
              "finite weights and objective")
        if pinned is not None and pinned[1] == 0:
            check(f"{name} guard", not mapper.x.any() and not mapper.b_opt.any(),
                  "the first Newton step raised the exact gradient norm; the fit rolled it "
                  "back and returned the zero model")
        else:
            check(f"{name} accuracy", acc[0] > 0.75 and acc[1] > 0.75,
                  "train and test accuracy above 75% (chance is 50%)")
        if name == f"IHS m={m2}":
            sketch_counts = counts
    raw, comp = (_w1(models[key]) for key in (f"IHS m={m2}",
                                              f"IHS compressed int16+bf16 m={m2}"))
    comp_delta, scale = float((comp - raw).abs().max()), float(raw.abs().max())
    check(f"compressed IHS within the bf16 tolerance of raw IHS at m={m2}",
          0 < scale and comp_delta <= 5e-3 * scale,
          f"max |W_compressed - W_raw| {comp_delta:.3e}, within 5e-3 of the largest weight "
          f"{scale:.4f} (bf16 values quantize the data; the draws are the same; 3 steps kept "
          f"by both)")
    report["compressed_max_abs_delta_vs_raw"] = comp_delta
    del models, raw, comp
    torch.cuda.empty_cache()
    report["time"] = phase_sketch_time(cuda_ops, rows)
    return sketch_counts, report


def phase_sketch_time(cuda_ops, rows):
    """Where one IHS fit's time goes (m = 32,770): one outer iteration's
    stages as the fit runs them, each timed with CUDA events — the fold
    pass (zeroing the accumulator and 8 ``countsketch_scatter`` launches),
    the gradient operand (8 gather + scatter passes), SAᵀSA, and the
    Cholesky factor and solve — and the one-time AᵀB pass. The pass's
    draws (CPU generator, then a copy to the card) are made before its
    start event and timed on the host clock, so no stage's device time
    includes the stream waiting on the host."""
    from keystone_tpu_torch.data.resident import raw_chunk_tiles
    from keystone_tpu_torch.ops.learning import sketch
    from keystone_tpu_torch.ops.sparse import sparse_matmul, sparse_matmul_t

    d1, m, n, c, k = AMAZON_D + 1, SKETCH_M, AMAZON_N, AMAZON_CHUNK, AMAZON_K
    dev = torch.device("cuda")
    est = sketch.IterativeHessianSketch(lam=AMAZON_LAM, sketch_size=m, seed=SKETCH_SEED,
                                        num_features=AMAZON_D)
    idx1, val1 = sketch._append_intercept(rows["train"][0], rows["train"][1], n, AMAZON_D)
    Y = rows["train"][3]
    idx_t, val_t, _ = raw_chunk_tiles(idx1, val1, Y, c)
    X = torch.zeros((d1, k), device=dev)
    times = {}

    def stage(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end)
        return out

    AtB = stage("AtB pass (once a fit)", lambda: sparse_matmul_t(idx1, val1, Y, d1))
    for rep in range(2):  # the first round warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = [est._draw((0, cid), c, m, dev) for cid in range(idx_t.shape[0])]
        torch.cuda.synchronize()
        draws_ms = 1e3 * (time.perf_counter() - t0)

        def fold():
            SA = torch.zeros((m, d1), device=dev)
            for cid, (bucket, sign) in enumerate(draws):
                cuda_ops.countsketch_scatter(idx_t[cid], val_t[cid], bucket, sign, m, d1, out=SA)
            return SA

        def gradient():
            AtAX = torch.zeros_like(X)
            for cid in range(idx_t.shape[0]):
                r = sparse_matmul(idx_t[cid], val_t[cid], X)
                AtAX += sparse_matmul_t(idx_t[cid], val_t[cid], r, d1)
            return AtAX

        SA = stage("fold pass (countsketch_scatter)", fold)
        AtAX = stage("gradient operand", gradient)
        g = AtAX / n - AtB / n + AMAZON_LAM * X

        def gram():
            H = SA.T @ SA
            H /= n
            H.diagonal().add_(AMAZON_LAM + 1e-8)
            return H

        H = stage("SA^T SA", gram)
        stage("Cholesky factor and solve",
              lambda: torch.cholesky_solve(g, torch.linalg.cholesky(H)))
        del SA, H, draws
    once = times.pop("AtB pass (once a fit)")
    outer = sum(times.values())
    log(f"  one IHS outer iteration, m {m}: {outer:.3f} ms of device time: " + ", ".join(
        f"{key} {v:.3f} ms ({100 * v / outer:.1f}%)" for key, v in times.items())
        + f"; AtB pass (once a fit) {once:.3f} ms; the pass's draws {draws_ms:.3f} ms of host "
        f"time before it")
    del idx1, val1, idx_t, val_t
    torch.cuda.empty_cache()
    return dict(stage_ms=times, outer_ms=outer, atb_ms=once, draws_host_ms=draws_ms)


def phase_sym_false(cuda_ops):
    """One stacked block update at TIMIT width through the reference's
    ``sym`` switch: ``sym=False`` (``gram_corr``, every Gramian tile) with
    the launch counts set to 0 just before and read just after, then
    ``sym=True`` (``gram_corr_sym``). The two give the same weights and
    residual: the dense kernel computes each lower tile with the same
    products in the same order as the mirrored upper one."""
    from keystone_tpu_torch.parallel import linalg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    X = torch.randn((N_TRAIN, D_IN), generator=gen, device=dev) * 0.6
    W = torch.randn((BLOCK, D_IN), generator=gen, device=dev) * 0.05555
    b = torch.rand((BLOCK,), generator=gen, device=dev) * 6.283185307179586
    A = cuda_ops.cosine_features(X, W, b)
    A -= A.mean(dim=0)
    labels = torch.randint(0, K, (N_TRAIN,), generator=gen, device=dev)
    R = 2.0 * torch.nn.functional.one_hot(labels, K).float() - 1.0
    R -= R.mean(dim=0)
    Wb = torch.zeros((BLOCK, K), device=dev)
    del X, W, b
    runs = {}
    for sym in (False, True):
        torch.cuda.synchronize()
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        R_new, W_new, _, _ = linalg._bcd_block_update(A, R, Wb, 0.0, sym=sym)
        torch.cuda.synchronize()
        runs[sym] = (R_new, W_new, dict(cuda_ops.launches), time.perf_counter() - t0)
    (Rd, Wd, counts, dense_s), (Rs, Ws, sym_counts, sym_s) = runs[False], runs[True]
    rel_W = float((Wd - Ws).norm() / Ws.norm())
    rel_R = float((Rd - Rs).norm() / Rs.norm())
    same = torch.equal(Wd, Ws) and torch.equal(Rd, Rs)
    log(f"  block update A {N_TRAIN}x{BLOCK}, R {N_TRAIN}x{K}: sym=False {dense_s:.3f} s "
        f"(launches {counts}), sym=True {sym_s:.3f} s; weights differ by {rel_W:.2e}, residual "
        f"by {rel_R:.2e} relative ({'the same bits' if same else 'not the same bits'})")
    expected = {kernel: 0 for kernel in cuda_ops.launches}
    expected["gram_corr"] = 1
    check("sym=False launches", same_launches(counts, expected), f"{counts}, expected {expected}")
    check("sym=True launches gram_corr_sym once",
          sym_counts["gram_corr_sym"] == 1 and sym_counts["gram_corr"] == 0, f"{sym_counts}")
    check("sym=False gives sym=True's update", rel_W <= 1e-5 and rel_R <= 1e-5
          and bool(torch.isfinite(Wd).all()),
          f"weights {rel_W:.2e}, residual {rel_R:.2e} relative (tol 1e-5)")
    del A, R, Wb, runs, Rd, Wd, Rs, Ws
    torch.cuda.empty_cache()
    return counts, dict(sym_false_seconds=dense_s, sym_true_seconds=sym_s,
                        weights_rel_diff=rel_W, residual_rel_diff=rel_R, same_bits=same)


# ---------------------------------------------------------------------------
# Phase 18: the workflow layer (plan verifier, auto-caching optimizer,
# single-datum programs)
# ---------------------------------------------------------------------------

# (b) bench.py's autocache_host_boundary geometry: n rows of 512 inputs, a
# host decode stage, 4,096 cosine features, 10 classes, data seed 6;
# BlockLeastSquares(512, 1, λ) over a cold 3-fit sweep and 3 warm ones, λ
# from logspace(-5, -2, 12), a 3 GiB budget, a 256-row probe after each fit.
CACHE_N, CACHE_D_IN, CACHE_D, CACHE_K, CACHE_SEED = 65536, 512, 4096, 10, 6
CACHE_SWEEPS, CACHE_FITS, CACHE_BUDGET, CACHE_PROBE = 4, 3, 3 << 30, 256
# (c) bench.py's autocache_on_chip chain: 512 -> 8,192 cosine -> rectify ->
# 8,192 -> 2,048 cosine on 131,072 rows (a plan probe, no fit).
CHAIN_N, CHAIN_DIMS = 131072, (512, 8192, 2048)
# (d) datum programs on phase 2's fitted TIMIT pipeline.
DATUM_GRAPH_N, DATUM_WALK_N, DATUM_TOL = 1000, 100, 1e-6
WORKFLOW = "workflow layer: verifier, auto-caching optimizer, datum programs"


class HostDecode:
    """bench.py's host decode stage, made a port Transformer at first use
    (the port is imported only once a card is found): device -> host,
    sign(x)·sqrt|x| in numpy, host -> device. Not device-fusable, so fusion
    cannot absorb it; it counts its full-size calls."""

    _cls = None

    @classmethod
    def make(cls, full_n):
        if cls._cls is None:
            from keystone_tpu_torch.data import Dataset
            from keystone_tpu_torch.workflow import Transformer

            class _HostDecode(Transformer):
                def __init__(self, full_n):
                    self.full_n = full_n
                    self.full_calls = 0

                def apply(self, x):
                    v = x.cpu().numpy()
                    return torch.from_numpy(np.sign(v) * np.sqrt(np.abs(v))).to(x.device)

                def batch_apply(self, ds):
                    if ds.n == self.full_n:
                        self.full_calls += 1
                    V = ds.array.cpu().numpy()
                    out = (np.sign(V) * np.sqrt(np.abs(V))).astype(np.float32)
                    return Dataset(torch.from_numpy(out).to(ds.array.device), n=ds.n)

            cls._cls = _HostDecode
        return cls._cls(full_n)


class HostPassthrough:
    """A host stage without a device function (identity): appended to a
    fitted graph, it makes the composition refuse, so datums walk the graph
    node by node."""

    _cls = None

    @classmethod
    def make(cls):
        if cls._cls is None:
            from keystone_tpu_torch.workflow import Transformer

            class _HostPassthrough(Transformer):
                def apply(self, x):
                    return x

            cls._cls = _HostPassthrough
        return cls._cls()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def first_verify():
    """The one-time cost of plan verification in a fresh process (``python3
    chip_smoke.py --first-verify``): the dry run's TIMIT fit graph built on
    the card, ``torch._dynamo`` imported (what PyTorch's Python meta
    kernels import at their first call; timed), then the graph verified
    twice. Prints one JSON line."""
    from keystone_tpu_torch.tools import dryrun
    from keystone_tpu_torch.workflow import verify

    graph = dryrun.BUILDERS["timit"](torch.device("cuda")).executor.graph
    loaded = "torch._dynamo" in sys.modules
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")  # what the first meta kernel call imports
    import_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        verify.verify_graph(graph, strict=True)
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(dynamo_loaded_before=loaded, dynamo_import_s=import_s,
                          first_verify_ms=times[0], second_verify_ms=times[1])))
    return 0


def phase_verify(cuda_ops, timit, n=NORTH_N, cosines=WIDE_COSINES, device="cuda"):
    """18(a): the north star's fit graph (TIMIT --solver auto, d = 204,800)
    with n real source rows on the card, verified in strict mode: no
    finding, no launch, no byte allocated; then the dry run's five
    pipelines on the card."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.tools import dryrun
    from keystone_tpu_torch.workflow import verify

    gen = torch.Generator(device=device).manual_seed(18)
    X = torch.randn(n, D_IN, generator=gen, device=device)
    y = torch.randint(0, K, (n,), generator=gen, device=device)
    labels = ClassLabelIndicatorsFromIntLabels(K)(Dataset(y))
    del y
    config = timit.TimitConfig(solver="auto", num_cosines=cosines, block_size=BLOCK,
                               num_epochs=EPOCHS)
    pipe = timit.build_featurizer(config, device=device).and_then(
        LeastSquaresEstimator(lam=0.0, block_size=BLOCK, block_iters=EPOCHS),
        Dataset(X), labels).and_then(MaxClassifier())
    graph = pipe.executor.graph
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated() if cuda else 0
    before = dict(cuda_ops.launches)
    t0 = time.perf_counter()
    verify.verify_graph(graph, strict=True)
    cold_ms = (time.perf_counter() - t0) * 1e3  # with the process's first dispatch mode
    t0 = time.perf_counter()
    report = verify.verify_graph(graph, strict=True)
    ms = (time.perf_counter() - t0) * 1e3
    mode = os.environ.get("KEYSTONE_VERIFY")
    os.environ["KEYSTONE_VERIFY"] = "strict"
    try:
        verify.verify_fit_graph(graph, context="phase 18(a)")
    finally:
        if mode is None:
            del os.environ["KEYSTONE_VERIFY"]
        else:
            os.environ["KEYSTONE_VERIFY"] = mode
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    feat = [s.describe() for s in report.sigs.values() if "204800" in s.describe()]
    log(f"  (a) n={n}, d={cosines * BLOCK}: {len(graph.operators)} nodes, "
        f"{sum(s.describe() != '?' for s in report.sigs.values())} of {len(report.sigs)} "
        f"signatures known, the combined features {feat[:1]}, verify_graph (strict) "
        f"{ms:.1f} ms ({cold_ms:.1f} ms the first time in the process), findings "
        f"{len(report.findings)}, allocated at the start "
        f"{start_bytes / 2**30:.3f} GiB, peak during {peak / 2**30:.3f} GiB")
    check("18(a) the north star's fit graph verifies clean in strict mode",
          not report.findings, "; ".join(map(str, report.findings)) or "no findings")
    check("18(a) the verifier launched nothing", dict(cuda_ops.launches) == before,
          f"{dict(cuda_ops.launches)} against {before}")
    check("18(a) the verifier allocated 0 bytes", peak == start_bytes,
          f"max_memory_allocated {peak} B, memory_allocated at the start {start_bytes} B")
    check("18(a) the combined features' signature is known",
          bool(feat) and f"f[{n},{cosines * BLOCK}]:float32" in feat[0], f"{feat[:1]}")
    del pipe, graph, labels, X
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = dryrun.dryrun(strict=True, device=device)
    dry_s = time.perf_counter() - t0
    lines = {name: len(r.findings) for name, r in reports.items()}
    log(f"  (a) the dry run's five pipelines on the card: findings {lines}, "
        f"{dry_s:.2f} s (building included)")
    check("18(a) the dry run is clean", len(reports) == 5 and not any(lines.values()), f"{lines}")
    once = {}
    if cuda:
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-verify"],
                               capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise RuntimeError(f"the first-verify process failed (rc {child.returncode}):\n"
                               f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
        once = json.loads(child.stdout.strip().splitlines()[-1])
        log(f"  (a) a fresh process: importing torch._dynamo {once['dynamo_import_s']:.2f} s "
            f"(loaded before: {once['dynamo_loaded_before']}), then the first verify_graph "
            f"of the dry run's TIMIT graph {once['first_verify_ms']:.1f} ms, the second "
            f"{once['second_verify_ms']:.1f} ms")
    return dict(first_process=once, verify_ms=ms, verify_first_ms=cold_ms, findings=len(report.findings),
                peak_bytes=peak,
                start_bytes=start_bytes, dryrun_findings=lines, dryrun_seconds=dry_s)


def _block_weights(fitted):
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

    (mapper,) = [op for op in fitted.transformer_graph.operators.values()
                 if isinstance(op, BlockLinearMapper)]
    return [x.clone() for x in mapper.xs]


def _cache_sweep(cuda_ops, make_optimizer, data, labels, crf, probe, lams, n, device):
    """bench.py's _run_cache_sweeps on the port: CACHE_SWEEPS sweeps of
    CACHE_FITS fits (the first cold), the env kept between sweeps, then a
    plan probe read off the rule. Returns walls, insertions, full-size
    decode calls, launches a fit and each λ's weights."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow import PipelineEnv, autocache

    env = PipelineEnv.get_or_create()
    env.reset()
    optimizer = make_optimizer()
    env.set_optimizer(optimizer)
    host = HostDecode.make(n)
    sweeps, fit_launches, weights = [], [], []
    for s in range(CACHE_SWEEPS):
        t0 = time.perf_counter()
        for lam in lams[CACHE_FITS * s: CACHE_FITS * (s + 1)]:
            cuda_ops.reset_launch_counts()
            fitted = host.to_pipeline().and_then(crf).and_then(
                BlockLeastSquaresEstimator(512, 1, float(lam)), data, labels).fit()
            fit_launches.append({k: v for k, v in cuda_ops.launches.items() if v})
            out = fitted.apply(Dataset(probe)).array
            float(out.abs().sum())  # a host read: the probe has run
            weights.append(_block_weights(fitted))
        sweeps.append(time.perf_counter() - t0)
    host.to_pipeline().and_then(crf).and_then(
        BlockLeastSquaresEstimator(512, 1, 3e-3), data, labels).executor.optimized_graph
    inserted = sum(len(getattr(r, "last_selection", ())) for b in optimizer.batches
                   for r in b.rules)
    env.reset()
    return dict(cold_sweep_s=sweeps[0], warm_sweeps_s=sweeps[1:], cache_insertions=inserted,
                full_size_decodes=host.full_calls, fit_launches=fit_launches), weights


def phase_autocache(cuda_ops, n=CACHE_N, device="cuda"):
    """18(b): DefaultOptimizer against AutoCachingOptimizer(GreedyCache(3
    GiB)) on the host-boundary λ-sweep."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import autocache
    from keystone_tpu_torch.workflow.optimizer import AutoCachingOptimizer, DefaultOptimizer

    rng = np.random.default_rng(CACHE_SEED)
    X = torch.from_numpy(rng.normal(size=(n, CACHE_D_IN)).astype(np.float32)).to(device)
    y = rng.integers(0, CACHE_K, size=n)
    Y = torch.from_numpy(2.0 * np.eye(CACHE_K, dtype=np.float32)[y] - 1.0).to(device)
    data, labels = Dataset(X), Dataset(Y)
    crf = CosineRandomFeatures(CACHE_D_IN, CACHE_D, 1e-2, seed=2, device=device)
    lams = np.logspace(-5, -2, CACHE_FITS * CACHE_SWEEPS)
    autocache.profile_fallbacks.clear()
    runs = {}
    for name, make in (("no_cache", DefaultOptimizer),
                       ("greedy_postfusion",
                        lambda: AutoCachingOptimizer(autocache.GreedyCache(CACHE_BUDGET)))):
        runs[name], w = _cache_sweep(cuda_ops, make, data, labels, crf, X[:CACHE_PROBE], lams,
                                     n, device)
        runs[name]["weights"] = w
        r = runs[name]
        log(f"  (b) {name}: cold sweep {r['cold_sweep_s']:.3f} s, warm sweeps "
            f"{[round(s, 3) for s in r['warm_sweeps_s']]} s, cache insertions "
            f"{r['cache_insertions']}, full-size host decodes {r['full_size_decodes']}, "
            f"launches a fit {r['fit_launches'][0]} (first), {r['fit_launches'][-1]} (last)")
    base, greedy = runs["no_cache"], runs["greedy_postfusion"]
    equal = [all(torch.equal(a, b) for a, b in zip(wa, wb))
             for wa, wb in zip(base.pop("weights"), greedy.pop("weights"))]
    fallbacks = list(autocache.profile_fallbacks)
    check("18(b) greedy places at least one Cacher", greedy["cache_insertions"] >= 1,
          f"{greedy['cache_insertions']} insertions")
    check("18(b) greedy decodes the full rows fewer times than the default optimizer",
          greedy["full_size_decodes"] < base["full_size_decodes"],
          f"{greedy['full_size_decodes']} against {base['full_size_decodes']}")
    check("18(b) each λ's weights bit-equal under both optimizers", all(equal),
          f"{sum(equal)} of {len(equal)} equal")
    check("18(b) no profiled node fell back to an empty profile", not fallbacks, f"{fallbacks}")
    return dict(n=n, dims=[CACHE_D_IN, CACHE_D], budget_bytes=CACHE_BUDGET, configs=runs,
                weights_bit_equal=all(equal), profile_fallbacks=len(fallbacks))


def phase_chain_plan(n=CHAIN_N, dims=CHAIN_DIMS, device="cuda"):
    """18(c): the fully fusable chain's plan under post-fusion greedy (no
    Cacher inside the fused program) beside the pre-fusion order's."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures, LinearRectifier
    from keystone_tpu_torch.ops.util import Cacher
    from keystone_tpu_torch.workflow import PipelineEnv, autocache, fusion
    from keystone_tpu_torch.workflow.optimizer import AutoCachingOptimizer

    d_in, d_mid, d_out = dims
    gen = torch.Generator(device=device).manual_seed(5)
    X = torch.randn(n, d_in, generator=gen, device=device)
    Y = torch.randn(n, 10, generator=gen, device=device)
    data, labels = Dataset(X), Dataset(Y)
    crf1 = CosineRandomFeatures(d_in, d_mid, 1e-2, seed=0, device=device)
    rect = LinearRectifier(0.0)
    crf2 = CosineRandomFeatures(d_mid, d_out, 1e-2, seed=1, device=device)
    out = {}
    for name, before in (("greedy_postfusion", False), ("greedy_prefusion", True)):
        env = PipelineEnv.get_or_create()
        env.reset()
        opt = AutoCachingOptimizer(autocache.GreedyCache(CACHE_BUDGET), cache_before_fusion=before)
        env.set_optimizer(opt)
        pipe = crf1.to_pipeline().and_then(rect).and_then(crf2).and_then(
            BlockLeastSquaresEstimator(512, 1, 3e-3), data, labels)
        g = pipe.executor.optimized_graph
        inserted = sum(len(getattr(r, "last_selection", ())) for b in opt.batches
                       for r in b.rules)
        cachers = [c for c in g.nodes if isinstance(g.get_operator(c), Cacher)]
        inside = [c for c in cachers
                  if fusion.cache_would_split_fusion(g, g.get_dependencies(c)[0], {})]
        fused = max((len(fusion.fused_members(g.get_operator(m))) for m in g.nodes), default=0)
        out[name] = dict(insertions=inserted, cachers=len(cachers), inside_fused=len(inside),
                         largest_fused_members=fused)
        env.reset()
    log(f"  (c) n={n}, {d_in} -> {d_mid} cosine -> rectify -> {d_out} cosine: {out}")
    post = out["greedy_postfusion"]
    check("18(c) post-fusion greedy places no Cacher inside the fused program",
          post["inside_fused"] == 0 and post["largest_fused_members"] >= 4,
          f"{post}")
    return out


def _strip_sink_node(fitted, extra=None):
    """The fitted graph without its last node (MaxClassifier: the scores
    are compared, not their argmax), with ``extra`` appended after."""
    from keystone_tpu_torch.workflow import FittedPipeline, TransformerGraph

    g = fitted.transformer_graph
    last = g.get_sink_dependency(fitted.sink)
    (dep,) = g.get_dependencies(last)
    g = g.set_sink_dependency(fitted.sink, dep).remove_node(last)
    if extra is not None:
        g, node = g.add_node(extra, [dep])
        g = g.set_sink_dependency(fitted.sink, node)
    return FittedPipeline(TransformerGraph.from_graph(g), fitted.source, fitted.sink)


def _datum_times(fitted, rows, device):
    outs, times = [], []
    for x in rows:
        t0 = time.perf_counter()
        y = fitted.apply(x)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e6)
        outs.append(y)
    times.sort()
    return torch.stack(outs), dict(median_us=statistics.median(times),
                                   p99_us=times[int(0.99 * (len(times) - 1))])


def phase_datum(cuda_ops, timit, n=N_TRAIN, cosines=NUM_COSINES, block=BLOCK,
                graph_n=DATUM_GRAPH_N, walk_n=DATUM_WALK_N, device="cuda"):
    """18(d): phase 2's fitted TIMIT pipeline (fit first) applied to single
    rows through the captured program and through the per-node walk."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = timit.TimitConfig(solver="block", num_cosines=cosines, block_size=block,
                               synthetic_n=n, num_epochs=EPOCHS)
    result = timit.run(config, device=device, fit_first=True)
    rows = synthetic_timit(n, seed=config.seed, device=device).data.array
    scores = _strip_sink_node(result.fitted)
    walk = _strip_sink_node(result.fitted, HostPassthrough.make())
    batch = scores.apply(Dataset(rows[:graph_n])).array
    cuda_ops.reset_launch_counts()
    graph_out, graph_t = _datum_times(scores, [rows[i] for i in range(graph_n)], device)
    graph_launches = {k: v for k, v in cuda_ops.launches.items() if v}
    programs = list(scores._datum_programs.values())
    cuda_ops.reset_launch_counts()
    walk_out, walk_t = _datum_times(walk, [rows[i] for i in range(walk_n)], device)
    walk_launches = {k: v for k, v in cuda_ops.launches.items() if v}
    rel = lambda a, b: ((a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1)).max()
    graph_rel, walk_rel = float(rel(graph_out, batch)), float(rel(walk_out, batch[:walk_n]))
    per = programs[0].launches_per_replay if programs else {}
    log(f"  (d) n={n}, d={cosines * block}: captured program {graph_n} datums, median "
        f"{graph_t['median_us']:.1f} us, p99 {graph_t['p99_us']:.1f} us, max relative "
        f"{graph_rel:.3e} from the batch apply's rows, programs {len(programs)} "
        f"(captures {[p.captures for p in programs]}, replays {[p.replays for p in programs]}, "
        f"mode {[p.mode for p in programs]}), launches a replay {per}, launches {graph_launches}; "
        f"per-node walk {walk_n} datums, median {walk_t['median_us']:.1f} us, p99 "
        f"{walk_t['p99_us']:.1f} us, max relative {walk_rel:.3e}, launches {walk_launches}")
    cuda = torch.device(device).type == "cuda"
    want = {"cosine_features": cosines * graph_n, ROW_STABLE: graph_n} if cuda else {}
    check("18(d) one program for the one input shape, captured once" if cuda else
          "18(d) one program for the one input shape",
          len(programs) == 1 and programs[0].captures == int(cuda)
          and programs[0].mode == ("graph" if cuda else "direct"),
          f"{len(programs)} programs")
    check("18(d) the captured program's launches counted replays included",
          graph_launches == want, f"{graph_launches}, expected {want}")
    check(f"18(d) the captured program within {DATUM_TOL} relative of the batch apply",
          graph_rel <= DATUM_TOL, f"{graph_rel:.3e}")
    check(f"18(d) the per-node walk within {DATUM_TOL} relative of the batch apply",
          walk_rel <= DATUM_TOL, f"{walk_rel:.3e}")
    PipelineEnv.get_or_create().reset()
    return dict(graph=dict(graph_t, datums=graph_n, max_rel=graph_rel, launches=graph_launches,
                           launches_per_replay=per),
                walk=dict(walk_t, datums=walk_n, max_rel=walk_rel, launches=walk_launches))


SERVE_MAX_BATCH, SERVE_REQUESTS, SERVE_POOL = 256, 40, 256
SERVE_TOL, SERVE_PLAIN_TOL = 1e-6, 1e-5
SERVE_CLI_S, SERVE_SWAP_RATE, SERVE_SWAP_S = 2.0, 400.0, 2.0
SERVE_RATES, SERVE_LATENCY_S = (200.0, 2000.0), 1.5
SERVING = "serving: exported bucketed plans, micro-batcher, replicated plane"


def _row_rel(a, b):
    """Largest row-wise relative distance of two numpy score matrices."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def serve_pool():
    """SERVE_POOL host rows of TIMIT's 440 inputs, the requests."""
    from keystone_tpu_torch.data.loaders import synthetic_timit

    return synthetic_timit(SERVE_POOL, seed=100, device="cpu").data.array.numpy()


def serve_scores(timit, seed, pool, device):
    """A fitted TIMIT scores pipeline (phase 2's width, fit first, the
    rows and features of ``seed``) and its offline batch apply of ``pool``."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = timit.TimitConfig(solver="block", num_cosines=NUM_COSINES, block_size=BLOCK,
                               synthetic_n=N_TRAIN, num_epochs=EPOCHS, seed=seed)
    scores = _strip_sink_node(timit.run(config, device=device, fit_first=True).fitted)
    PipelineEnv.get_or_create().reset()
    offline = scores.apply(Dataset(torch.from_numpy(pool).to(device))).array.cpu().numpy()
    return scores, offline


def _bits_by_stage(plan, pool, device, batch, offline_plan=None, served=None, rows=2):
    """Where a served row's bits part from a batch apply's: each stage of
    the plan's one fused node run on ``batch`` rows and on their first
    ``rows`` (each fed the batch run's previous output), the composed
    function eager at ``rows`` against its first rows at ``batch``, and a
    bucket's replay against the eager function at the bucket; given them,
    the eager function at ``batch`` against the plan's batch apply and the
    served rows against the eager function at ``batch``; and the composed
    function on the first row alone against that row at ``batch``. Bit
    for bit, with the largest difference and the first rows that differ."""
    from keystone_tpu_torch.workflow.fusion import fused_members

    def cmp(a, b):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        rows_off = torch.nonzero((a != b).reshape(a.shape[0], -1).any(1)).flatten()
        return dict(bits=bool(torch.equal(a, b)), max_abs_diff=float((a - b).abs().max()),
                    rows_differing=rows_off.tolist()[:8])

    (node,) = plan.graph.nodes
    op = plan.graph.get_operator(node)
    X = torch.from_numpy(pool[:batch]).to(device)
    stages, Y = [], X
    for member in fused_members(op) or [op]:
        fn = member.device_fn()
        Z = fn(Y)
        stages.append(dict(stage=type(member).__name__, **cmp(Z[:rows], fn(Y[:rows].clone()))))
        Y = Z
    eager = plan._composed(X)
    few = plan._composed(X[:rows].clone())
    # A one-row call (the chunked batch apply's probe, ROADMAP C.8) against
    # the same row computed with the batch.
    one = plan._composed(X[:1].clone())
    out = dict(batch=batch, stages=stages, eager_rows_vs_batch=cmp(few, eager[:rows]),
               eager_one_row_vs_batch=cmp(one, eager[:1]),
               replay_vs_eager=cmp(plan.apply_padded(pool[:rows]), few))
    if offline_plan is not None:
        out["eager_batch_vs_batch_apply"] = cmp(eager, offline_plan)
    if served is not None:
        out["served_vs_eager_batch"] = cmp(served, eager)
    return out


def phase_serve_plan(cuda_ops, timit, device="cuda"):
    """19(a): the TIMIT scores plan, its buckets, launches and bits."""
    from keystone_tpu_torch.serving import MicroBatchServer, export_plan

    cuda = torch.device(device).type == "cuda"
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.workflow import FittedPipeline

    pool = serve_pool()
    scores, offline = serve_scores(timit, 0, pool, device)
    t0 = time.perf_counter()
    plan = export_plan(scores, np.zeros(D_IN, np.float32), max_batch=SERVE_MAX_BATCH)
    export_s = time.perf_counter() - t0
    # Offline apply of the exported plan's (fused) graph: the same function
    # as a bucket program, at the whole batch of rows. The fitted
    # pipeline's own apply walks its nodes unfused, so it is held within a
    # tolerance (its block mapper takes the same row-stable product).
    offline_plan = FittedPipeline(plan.graph, plan.source, plan.sink).apply(
        Dataset(torch.from_numpy(pool[:SERVE_REQUESTS]).to(device))).array.cpu().numpy()
    built = plan.trace_count
    per = plan.launches_per_replay
    check("19(a) every bucket built once at export" + (", captured" if cuda else ""),
          plan.compiled and built == len(plan.buckets)
          and sorted(per) == (plan.buckets if cuda else []),
          f"buckets {plan.buckets}, built {built}, captured {len(per)}, "
          f"export {export_s:.3f} s, pinned {plan.pinned_bytes} bytes")
    want_per = {"cosine_features": NUM_COSINES, ROW_STABLE: 1}
    check("19(a) each replay launches cosine_features once a branch and the row-stable "
          "product once",
          all(v == want_per for v in per.values()), f"{per}")
    replays0 = plan.replays
    cuda_ops.reset_launch_counts()
    server = MicroBatchServer(plan, max_batch=SERVE_MAX_BATCH, max_wait_ms=2.0)
    rng = np.random.default_rng(19)
    try:
        futures = []
        for i in range(SERVE_REQUESTS):
            futures.append(server.submit(pool[i]))
            time.sleep(float(rng.uniform(0.0, 0.004)))
        served = np.stack([f.result(timeout=120) for f in futures])
        stats = server.stats()
    finally:
        server.close()
    launches = {k: v for k, v in cuda_ops.launches.items() if v}
    replays = {b: n - replays0.get(b, 0) for b, n in plan.replays.items()}
    batches = sum(replays.values())
    want = {"cosine_features": NUM_COSINES * batches, ROW_STABLE: batches} if cuda else {}
    bits = bool(np.array_equal(served, offline_plan))
    max_abs = float(np.abs(served - offline_plan).max())
    rel = _row_rel(served, offline[:SERVE_REQUESTS])
    log(f"  (a) {SERVE_REQUESTS} staggered requests: {batches} batches ({stats['completed']} "
        f"completed), replays a bucket {replays}, launches {launches}; served against the "
        f"plan's offline apply: bit_identical {bits}, max_abs_diff {max_abs:.3e}; against the "
        f"fitted pipeline's apply: max relative {rel:.3e}")
    stages = [_bits_by_stage(plan, pool, device, SERVE_REQUESTS, offline_plan, served),
              _bits_by_stage(plan, pool, device, SERVE_POOL)]
    for reading in stages:
        log(f"  (a) where the bits part, 2 rows against {reading['batch']}: {reading}")
    check("19(a) cosine_features and row_stable_matmul launches = launches a replay x "
          "batches served",
          launches == want and (batches > 1 or not cuda), f"{launches}, expected {want}")
    check("19(a) served rows bit-identical to the plan's offline apply" if cuda else
          "19(a) served rows near the plan's offline apply (MKL sums by the batch's size)",
          bits if cuda else _row_rel(served, offline_plan) <= SERVE_TOL,
          f"bit identical {bits}, max_abs_diff {max_abs:.3e}")
    check(f"19(a) served rows within {SERVE_TOL} relative of the fitted pipeline's apply "
          "(its nodes walked unfused)", rel <= SERVE_TOL, f"{rel:.3e}")
    plain = {}
    kernel = cuda_ops.cosine_features

    def plain_cosine(X, W, b, compute_dtype=torch.float32, out_dtype=None, out=None):
        Y = cuda_ops.cosine_features_ref(X, W, b, compute_dtype, out_dtype)
        return Y if out is None else out.copy_(Y)

    for b in plan.buckets:
        X = pool[:b]
        got = plan.apply_padded(X)
        cuda_ops.cosine_features = plain_cosine  # the gather writes into columns (out=)
        try:
            want_b = plan._composed(torch.from_numpy(X).to(device)).cpu().numpy()
        finally:
            cuda_ops.cosine_features = kernel
        plain[b] = _row_rel(got, want_b)
    worst = max(plain.values())
    check(f"19(a) each bucket program within {SERVE_PLAIN_TOL} relative of its plain-kernel twin",
          worst <= SERVE_PLAIN_TOL, f"{ {b: f'{v:.2e}' for b, v in plain.items()} }")
    single_s = plan.measure_single_request_s()
    check("19(a) serving captured nothing", plan.trace_count == built,
          f"trace_count {plan.trace_count} after serving, {built} at export")
    log(f"  (a) single_request_s {single_s:.6f}, export {export_s:.3f} s")
    return plan, scores, pool, offline, dict(
        buckets=plan.buckets, export_s=export_s, trace_count=built, launches=launches,
        launches_per_replay={str(b): v for b, v in per.items()}, batches=batches,
        bit_identical=bits, max_abs_diff=max_abs, max_rel=rel, single_request_s=single_s,
        bits_by_stage=stages,
        plain_rel=max(plain.values()))


def phase_serve_cli(cuda_ops, device="cuda"):
    """19(b): ``run.py serve`` at the MnistRandomFFT defaults, one replica
    and then two, in this process."""
    import contextlib
    import io

    from keystone_tpu_torch import run as cli
    from keystone_tpu_torch.workflow import PipelineEnv

    cuda = torch.device(device).type == "cuda"
    out = {}
    for replicas in (1, 2):
        PipelineEnv.get_or_create().reset()
        cuda_ops.reset_launch_counts()
        argv = ["serve", "--rate", "200", "--duration-s", str(SERVE_CLI_S),
                "--replicas", str(replicas)] + ([] if cuda else ["--device", "cpu"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches = {k: v for k, v in cuda_ops.launches.items() if v}
        PipelineEnv.get_or_create().reset()
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        books = summary["num_offered"] == (summary["num_samples"] + summary["rejected"]
                                           + summary["failed"])
        log(f"  (b) --replicas {replicas}: {json.dumps(summary)}; launches {launches}")
        check(f"19(b) serve --replicas {replicas}: exit 0, books balance, none failed, "
              "the plan composed",
              rc == 0 and books and summary["failed"] == 0 and summary["plan_compiled"],
              f"rc {rc}, offered {summary['num_offered']}, completed {summary['num_samples']}, "
              f"rejected {summary['rejected']}, failed {summary['failed']}")
        want = MNIST_LAUNCHES[True] if cuda else {}
        check(f"19(b) serve --replicas {replicas}: the quick fit's launches",
              same_launches(launches, want), f"{launches}, expected {want}")
        out[f"replicas_{replicas}"] = dict(summary=summary, launches=launches)
    return out


def phase_serve_swap(cuda_ops, timit, plan, pool, device="cuda", fits=None):
    """19(c): a hot swap between two TIMIT plans under Poisson load. The
    seed-1 fit is appended to ``fits`` when given (phase 22's tenants)."""
    import threading

    from keystone_tpu_torch.serving import ReplicatedServer, export_plan, poisson_arrivals

    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.workflow import FittedPipeline

    scores2, _ = serve_scores(timit, 1, pool, device)
    if fits is not None:
        fits.append(scores2)
    plan2 = export_plan(scores2, np.zeros(D_IN, np.float32), max_batch=SERVE_MAX_BATCH)
    X = torch.from_numpy(pool).to(device)
    want = {p.fingerprint: FittedPipeline(p.graph, p.source, p.sink).apply(
        Dataset(X)).array.cpu().numpy() for p in (plan, plan2)}
    arrivals = poisson_arrivals(SERVE_SWAP_RATE, SERVE_SWAP_S, seed=3)
    server = ReplicatedServer(plan, num_replicas=2, max_batch=SERVE_MAX_BATCH, max_wait_ms=2.0)
    swap = {}

    def do_swap():
        time.sleep(SERVE_SWAP_S / 2)
        t0 = time.perf_counter()
        swap["report"] = server.swap_plan(plan2, drain_timeout_s=60)
        swap["seconds"] = time.perf_counter() - t0

    futures, refused = [], []
    swapper = threading.Thread(target=do_swap)
    try:
        swapper.start()
        start = time.perf_counter()
        for i, t in enumerate(arrivals):
            delay = start + t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                futures.append((i, server.submit(pool[i % SERVE_POOL])))
            except Exception as e:
                refused.append(repr(e))
        swapper.join(timeout=120)
        results = [(i, getattr(f, "plan_fingerprint", None), f.result(timeout=120))
                   for i, f in futures]
    finally:
        server.close()
    by_fp = {}
    worst, same_bits = 0.0, 0
    for i, fp, y in results:
        by_fp[fp] = by_fp.get(fp, 0) + 1
        if fp in want:
            worst = max(worst, _row_rel(y[None], want[fp][i % SERVE_POOL][None]))
            same_bits += bool(np.array_equal(y, want[fp][i % SERVE_POOL]))
    log(f"  (c) {len(arrivals)} arrivals at {SERVE_SWAP_RATE:.0f} Hz, swap at "
        f"{SERVE_SWAP_S / 2:.1f} s took {swap.get('seconds', float('nan')):.3f} s, responses by "
        f"fingerprint {by_fp}, refused {len(refused)}, worst relative {worst:.3e}, "
        f"{same_bits} of {len(results)} bit-identical to their plan's batch apply of "
        f"{SERVE_POOL} rows")
    check("19(c) the swap finished", not swapper.is_alive() and "report" in swap,
          f"{swap.get('report')}")
    check("19(c) every response carries one of the two fingerprints, both served",
          set(by_fp) == set(want), f"{by_fp}, plans {list(want)}")
    check("19(c) no request dropped", not refused and len(results) == len(arrivals),
          f"{len(results)} of {len(arrivals)} answered, refused {refused[:3]}")
    check(f"19(c) each response within {SERVE_TOL} relative of its plan's offline rows",
          worst <= SERVE_TOL, f"{worst:.3e}")
    return dict(arrivals=len(arrivals), by_fingerprint=by_fp, swap_s=swap["seconds"],
                max_rel=worst, bit_identical=same_bits, answered=len(results))


def phase_serve_latency(plan, scores, pool, smi, device="cuda"):
    """19(d): open-loop latency at three rates, beside the same plan at
    max_batch 1."""
    from keystone_tpu_torch.serving import (
        MicroBatchServer,
        closed_loop_qps,
        export_plan,
        run_open_loop,
    )

    plan1 = export_plan(scores, np.zeros(D_IN, np.float32), max_batch=1)
    base = closed_loop_qps(lambda x: plan1.apply_batch([x]), lambda i: pool[i % SERVE_POOL],
                           num_requests=200)
    rates = list(SERVE_RATES) + [0.8 * base["qps"]]
    log(f"  (d) batch-size-1 closed loop: {base['qps']:.1f} qps, p50 "
        f"{1e3 * base['p50_latency_s']:.3f} ms, p99 {1e3 * base['p99_latency_s']:.3f} ms ({smi})")
    rows = []
    for rate in rates:
        for label, p, mb in (("micro-batched", plan, SERVE_MAX_BATCH), ("batch size 1", plan1, 1)):
            server = MicroBatchServer(p, max_batch=mb, max_wait_ms=2.0)
            try:
                report = run_open_loop(server.submit, lambda i: pool[i % SERVE_POOL],
                                       rate_hz=rate, duration_s=SERVE_LATENCY_S, seed=5)
            finally:
                server.close()
            row = report.to_row_dict()
            row.update(server=label, rate_hz=rate)
            rows.append(row)
            log(f"  (d) {rate:8.1f} Hz {label:>13}: p50 {row['p50_latency_ms']} ms, p99 "
                f"{row['p99_latency_ms']} ms, {row['achieved_qps']} qps, offered "
                f"{row['num_offered']}, rejected {row['rejected']}, failed {row['failed']}")
            check(f"19(d) {label} at {rate:.0f} Hz: none failed", row["failed"] == 0,
                  f"{row['failed']} failed")
    return dict(closed_loop_bs1=base, rows=rows, card=smi)


# 20(a): the row-stable product at TIMIT's scores shape (16,384 cosines ->
# 147 classes): the serving plan's smallest and largest buckets and a
# 65,536-row batch apply.
RS_ROWS, RS_TOL_TERMS = (2, 256, 65536), 256 + 64
# 20(c): run.py learn at its defaults and at TIMIT's raw frame width.
LEARN_ARGV = ([], ["--input-dim", str(D_IN), "--out-dim", str(K)])
LEARN_SEGMENTS = 24
# 20(d): the TIMIT-width gate under Poisson load; 20(e): the killed trainer.
LEARN_STORM_RATE, LEARN_STORM_S, LEARN_HOLDOUT = 400.0, 6.0, 2048
LEARN_KILL_SEGMENTS, LEARN_KILL_AT = 8, 5


def phase_row_stable(cuda_ops, device="cuda"):
    """20(a): row_stable_matmul at bucket 2, bucket 256 and 65,536 rows x
    16,384 x 147: against its plain version and float64 (inside the
    rounding bound of its sums, (256 chunk terms + 64 chunk sums) x 2^-24 x
    |X| |W|), rows bit-equal across the three row counts; its time, bound
    and cuBLAS's ``X @ W`` time at each."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20)
    m_max, k, n = RS_ROWS[-1], D_FEAT, K
    X = torch.randn((m_max, k), generator=gen, device=dev) * 0.5
    W = torch.randn((k, n), generator=gen, device=dev) * 0.01
    full = cuda_ops.row_stable_matmul(X, W)
    exact = X.double() @ W.double()
    bound = RS_TOL_TERMS * 2.0 ** -24 * (X.abs().double() @ W.abs().double())
    shapes, worst_plain = {}, 0.0
    for m in RS_ROWS:
        Xm = X[:m]
        got = full if m == m_max else cuda_ops.row_stable_matmul(Xm, W)
        plain = cuda_ops.row_stable_matmul_ref(Xm, W)
        err64 = (got.double() - exact[:m]).abs()
        inside = bool((err64 <= bound[:m]).all())
        same_rows = bool(torch.equal(got, full[:m]))
        err = float((got - plain).abs().max())
        worst_plain = max(worst_plain, err)
        nbytes, flops = 4 * (m * k + k * n + m * n), 2 * m * k * n
        bms, bby = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        row = dict(max_abs_err=err, max_abs_err_f64=float(err64.max()),
                   ms=time_ms(lambda: cuda_ops.row_stable_matmul(Xm, W), 5),
                   plain_ms=time_ms(lambda: cuda_ops.row_stable_matmul_ref(Xm, W), 1),
                   library_ms=time_ms(lambda: Xm @ W, 5), bound_ms=bms, bound_by=bby)
        if device == "cuda":
            if m <= SERVE_MAX_BATCH:  # a short call: its time a call is the host's
                row["device_ms"] = device_ms(lambda: cuda_ops.row_stable_matmul(Xm, W), 50)
                row["library_device_ms"] = device_ms(lambda: Xm @ W, 50)
            row["grid"] = cuda_ops.row_stable_matmul_grid(m, n, k, dev)
        shapes[f"{m}x{k}x{n}"] = row
        log(f"  (a) {m} x {k} x {n}: {row['ms']:.4f} ms (device "
            f"{row.get('device_ms', float('nan')):.4f}), cuBLAS {row['library_ms']:.4f} ms "
            f"(device {row.get('library_device_ms', float('nan')):.4f}), plain "
            f"{row['plain_ms']:.3f} ms, bound {bms:.4f} ms by {bby}; max abs against the "
            f"plain version {err:.3e}, against float64 {row['max_abs_err_f64']:.3e}; grid "
            f"{row.get('grid')}")
        check(f"20(a) row_stable_matmul at {m} rows inside the rounding bound of float64",
              inside, f"{float((err64 - bound[:m]).max()):.3e} past it")
        check(f"20(a) row_stable_matmul at {m} rows: each row the bits of the "
              f"{m_max}-row call", same_rows, f"bit-equal {same_rows}")
        check(f"20(a) row_stable_matmul at {m} rows within twice the bound of its plain "
              "version", bool(((got - plain).abs().double() <= 2 * bound[:m]).all()),
              f"max abs {err:.3e}")
    del X, W, full, exact, bound
    torch.cuda.empty_cache()
    top = dict(shapes[f"{RS_ROWS[0]}x{k}x{n}"])
    top.pop("grid", None)
    top.update(max_abs_err=worst_plain, shapes=shapes)
    return top


def phase_learn_gate(plan, serve_plan, swap):
    """20(b): the TIMIT scores plan passes the gate's bucket dry run (every
    bucket the same bits), phase 19(c)'s swap responses are each their
    plan's 256-row batch apply bit for bit, and the single-request time
    beside phase 19's reading before the row-stable product."""
    from keystone_tpu_torch.serving.lifecycle import _bucket_identity_mismatch

    mismatch = _bucket_identity_mismatch(plan)
    log(f"  (b) bucket dry run over {plan.buckets}: {mismatch or 'all bit-equal'}; "
        f"19(c) {swap['bit_identical']} of {swap['answered']} responses bit-equal to their "
        f"plan's {SERVE_POOL}-row batch apply; single request "
        f"{1e3 * serve_plan['single_request_s']:.3f} ms (0.280 ms before the row-stable "
        "product, PERF.md)")
    check("20(b) the TIMIT plan's buckets give the same bits", mismatch is None, f"{mismatch}")
    check("20(b) every swap response equals its plan's batch apply bit for bit",
          swap["bit_identical"] == swap["answered"] > 0,
          f"{swap['bit_identical']} of {swap['answered']}")
    return dict(buckets=plan.buckets, mismatch=mismatch, swap_bit_identical=swap["bit_identical"],
                swap_answered=swap["answered"], single_request_s=serve_plan["single_request_s"])


def phase_learn_cli(device="cuda"):
    """20(c): ``run.py learn`` at its defaults and at 440 -> 147: the books
    balance, 3 or more published, none rejected at the gate, staleness
    measured, every segment fit."""
    import contextlib
    import io

    from keystone_tpu_torch import run as cli

    out = {}
    for extra in LEARN_ARGV:
        argv = ["learn", "--segments", str(LEARN_SEGMENTS)] + extra + (
            [] if torch.device(device).type == "cuda" else ["--device", "cpu"])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        label = "defaults" if not extra else "440 -> 147"
        log(f"  (c) learn {label} ({wall:.1f} s): {json.dumps(summary)}")
        check(f"20(c) learn {label}: exit 0, books balance, >= 3 published, none rejected at "
              "the gate, staleness measured, every segment fit",
              rc == 0 and summary["accounting_ok"] and summary["num_published"] >= 3
              and summary["gate_rejected"] == 0 and summary["staleness_s"] is not None
              and summary["trainer_segments_fit"] == LEARN_SEGMENTS,
              f"rc {rc}, accounting_ok {summary['accounting_ok']}, published "
              f"{summary['num_published']}, gate_rejected {summary['gate_rejected']}, "
              f"staleness_s {summary['staleness_s']}, segments {summary['trainer_segments_fit']}")
        out[label] = dict(summary, wall_s=wall)
    return out


def _with_nan_weight(fitted):
    """A copy of a fitted pipeline whose linear model holds one NaN."""
    import copy

    from keystone_tpu_torch.workflow.fusion import fused_members

    bad = copy.deepcopy(fitted)
    for node in bad.transformer_graph.nodes:
        op = bad.transformer_graph.get_operator(node)
        for member in fused_members(op) + [op]:
            weights = getattr(member, "xs", None) or [getattr(member, "x", None)]
            if isinstance(weights[0], torch.Tensor):
                weights[0].view(-1)[0] = float("nan")
                return bad
    raise AssertionError("no linear model in the pipeline")


def phase_learn_timit(timit, plan, pool, device="cuda"):
    """20(d): the lifecycle gate at TIMIT width on 2 replicas under Poisson
    load: a NaN-weight candidate is rejected and serves nothing; the seed-1
    TIMIT plan passes the gate (held-out scores on fresh TIMIT rows), the
    canary and promotion."""
    import threading

    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.serving import LifecycleController, ReplicatedServer, run_open_loop

    held = synthetic_timit(LEARN_HOLDOUT, seed=101, device="cpu")
    Xh = held.data.array.numpy()
    yh = ClassLabelIndicatorsFromIntLabels(K)(held.labels).array.numpy()
    scores2, _ = serve_scores(timit, 1, pool[:1], device)
    nan_candidate = _with_nan_weight(scores2)
    plane = ReplicatedServer(plan, num_replicas=2, max_batch=SERVE_MAX_BATCH, max_wait_ms=2.0)
    holder = {}

    def storm():
        holder["report"] = run_open_loop(plane.submit, lambda i: pool[i % SERVE_POOL],
                                         rate_hz=LEARN_STORM_RATE, duration_s=LEARN_STORM_S,
                                         seed=20)

    ctl = LifecycleController(plane, plan, holdout=(Xh, yh), canary_sustain_s=1.0,
                              canary_min_samples=20)
    stormer = threading.Thread(target=storm)
    try:
        stormer.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        bad = ctl.offer(nan_candidate)
        t1 = time.perf_counter()
        good = ctl.offer(scores2)
        t2 = time.perf_counter()
        stormer.join(timeout=120)
        first = plane.first_completion_times()
        stats = ctl.stats()
    finally:
        ctl.close()
        plane.close()
    report = holder["report"]
    books = report.num_offered == report.completed + report.rejected + report.failed
    log(f"  (d) {report.num_offered} requests at {LEARN_STORM_RATE:.0f} Hz on 2 replicas, "
        f"by fingerprint {report.per_fingerprint_completed}, rejected {report.rejected}, failed "
        f"{report.failed}; NaN candidate {bad} ({t1 - t0:.3f} s); seed-1 candidate "
        f"{ {k: v for k, v in good.items() if k != 'canary'} } ({t2 - t1:.3f} s), canary "
        f"{good.get('canary')}; decisions {[(d['action'], d['reason']) for d in stats['decisions']]}")
    check("20(d) the NaN candidate is rejected at the gate and serves nothing",
          not bad["published"] and bad["reason"] == "non_finite_weights"
          and bad["fingerprint"] not in first
          and bad["fingerprint"] not in report.per_fingerprint_completed, f"{bad}")
    check("20(d) the seed-1 TIMIT plan passes the gate and the canary and is promoted",
          good["published"] and good["reason"] == "promoted" and good["canary"] is not None
          and not good["canary"]["regressed"] and ctl.incumbent_fingerprint == good["fingerprint"]
          and good["fingerprint"] in report.per_fingerprint_completed,
          f"{ {k: v for k, v in good.items() if k != 'canary'} }, canary {good.get('canary')}")
    check("20(d) the books balance under the gate's swaps, none failed",
          books and report.failed == 0, f"offered {report.num_offered}, completed "
          f"{report.completed}, rejected {report.rejected}, failed {report.failed}")
    return dict(nan=bad, good={k: v for k, v in good.items() if k != "canary"},
                canary=good.get("canary"), nan_offer_s=t1 - t0, good_offer_s=t2 - t1,
                load=report.to_row_dict())


def phase_learn_resume(device="cuda"):
    """20(e): a trainer at 440 -> 147 killed mid-fit at ``trainer.fit`` with
    a checkpoint directory resumes and publishes the fingerprint of an
    uninterrupted run's final candidate."""
    import shutil
    import tempfile

    from keystone_tpu_torch.data.durable import CheckpointSpec
    from keystone_tpu_torch.learning import ContinuousTrainer, TimedSegmentFeed
    from keystone_tpu_torch.ops.learning.linear import LinearMapper
    from keystone_tpu_torch.serving import LifecycleController, ReplicatedServer, export_plan
    from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline, TransformerGraph

    rng = np.random.default_rng(20)
    W_true = rng.normal(size=(D_IN, K)).astype(np.float32)
    segs = []
    for _ in range(LEARN_KILL_SEGMENTS):
        Xs = rng.normal(size=(256, D_IN)).astype(np.float32)
        segs.append((Xs, (Xs @ W_true + 0.01 * rng.normal(size=(256, K))).astype(np.float32)))
    example = np.zeros(D_IN, np.float32)
    ref = ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=4)
    ref.run()
    ref_fp = export_plan(ref.candidates[-1], example, max_batch=64, device=device).fingerprint
    pipe = LinearMapper(np.zeros((D_IN, K), np.float32)).to_pipeline()
    plan0 = export_plan(FittedPipeline(TransformerGraph.from_graph(pipe.executor.graph),
                                       pipe.source, pipe.sink), example, max_batch=64,
                        device=device)
    plane = ReplicatedServer(plan0, num_replicas=2, max_batch=64, max_wait_ms=1.0)
    directory = tempfile.mkdtemp(prefix="learn-resume-")
    try:
        ctl = LifecycleController(plane, plan0, canary_sustain_s=0.0)
        spec = CheckpointSpec(directory, every_segments=2)
        killed = ContinuousTrainer(TimedSegmentFeed(segs), ctl, publish_every_k=4,
                                   checkpoint=spec)
        with FaultPlan([FaultRule("trainer.fit", calls=[LEARN_KILL_AT],
                                  exc="RuntimeError")]).active():
            killed.start()
            killed.join(timeout=120)
        snap = spec.has_snapshot()
        resumed = ContinuousTrainer(TimedSegmentFeed(segs), ctl, publish_every_k=4,
                                    checkpoint=spec)
        resumed.start()
        resumed.join(timeout=120)
        incumbent = ctl.incumbent_fingerprint
    finally:
        plane.close()
        shutil.rmtree(directory, ignore_errors=True)
    log(f"  (e) killed at fold {LEARN_KILL_AT}: {killed.error!r}, snapshot {snap}, published "
        f"{killed.stats()['published']}; resumed: resumes {resumed.resumes}, segments "
        f"{resumed.segments_fit}, published {resumed.stats()['published']}; incumbent "
        f"{incumbent}, uninterrupted run's {ref_fp}")
    check("20(e) the killed trainer resumes from its snapshot and publishes the uninterrupted "
          "run's fingerprint",
          isinstance(killed.error, RuntimeError) and snap and resumed.error is None
          and resumed.resumes == 1
          and resumed.segments_fit == LEARN_KILL_SEGMENTS - (LEARN_KILL_AT - 1)
          and incumbent == ref_fp,
          f"error {killed.error!r}, snapshot {snap}, resumes {resumed.resumes}, segments "
          f"{resumed.segments_fit}, incumbent {incumbent} against {ref_fp}")
    return dict(killed_published=killed.stats()["published"], resumes=resumed.resumes,
                resumed_segments=resumed.segments_fit, fingerprint=incumbent, expected=ref_fp)


DISK = "disk tier: TIMIT and Amazon folded from disk shards"
# Phase 21(a): the north star's n from disk, TIMIT-shaped (440 inputs, 147
# classes, 4 x 4,096 cosines), tiles of 8,192 rows and 2 tiles a segment as
# the reference's out-of-core bench leg (bench.py:3222): 269 tiles (268
# full and one of 4,544 rows), 135 segments (the last holds one tile). The
# host budget sits below the raw rows' 3.9 GB, so every resident candidate
# is infeasible.
DISK_N, DISK_TILE, DISK_TPS, DISK_TEST = 2200000, 8192, 2, 65536
DISK_TILES = -(-DISK_N // DISK_TILE)
DISK_RAGGED = DISK_N - (DISK_TILES - 1) * DISK_TILE
DISK_SEGMENTS = -(-DISK_TILES // DISK_TPS)
DISK_LAM, DISK_HOST_BUDGET, DISK_BLOCK_ROWS = 1e-4, 1 << 30, 65536
DISK_PEAK_OVER_PRICED = 0.20
# Phase 21(b): snapshots every 48 segments (after 48 and 96); the read of
# segment 100 fails its three attempts, so the rerun resumes at 96.
DISK_CKPT_EVERY, DISK_KILL_SEGMENT = 48, 100
# Phase 21(c): phase 8's Amazon rows in chunks of 65,536, 2 a segment.
DISK_COO_CPS = 2
# Phase 21(d): the CSV and image spill paths.
DISK_CSV_N, DISK_IMAGES, DISK_IMAGE_SIZE, DISK_IMAGE_SEGMENT = 65536, 5011, 64, 64


def disk_row_blocks(n, seed, device="cuda", block=DISK_BLOCK_ROWS):
    """TIMIT-shaped rows made on ``device`` a block at a time: class means
    0.6 x N(0, 1) drawn from a fixed seed (shared by every row set), then
    per row a uniform class, its mean plus N(0, 1) noise, and the ±1
    one-hot target; the same ``seed`` gives the same rows. Yields (X, Y,
    class labels) blocks."""
    means = 0.6 * torch.randn((K, D_IN), generator=torch.Generator(device=device).manual_seed(1234),
                              device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, n, block):
        m = min(block, n - lo)
        labels = torch.randint(0, K, (m,), generator=gen, device=device)
        X = means[labels] + torch.randn((m, D_IN), generator=gen, device=device)
        Y = 2.0 * torch.nn.functional.one_hot(labels, K).to(torch.float32) - 1.0
        yield X, Y, labels


def _streamed_model(fitted):
    from keystone_tpu_torch.ops.learning.streaming_ls import StreamingFeaturizedLinearModel

    (model,) = [op for op in fitted.transformer_graph.operators.values()
                if isinstance(op, StreamingFeaturizedLinearModel)]
    return model


def _disk_fit(cuda_ops, timit, TimitConfig, sld, depth, device):
    """One Pipeline fit of the cosine featurizer -> LeastSquaresEstimator
    on the shard-backed rows at prefetch ``depth``, launches counted from
    0. Returns (fitted, selector, seconds, launches, run peak bytes)."""
    from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK, num_epochs=EPOCHS,
                         lam=DISK_LAM)
    auto = LeastSquaresEstimator(lam=DISK_LAM, block_size=BLOCK, block_iters=EPOCHS,
                                 host_budget_bytes=DISK_HOST_BUDGET)
    auto._streaming_choice.prefetch_depth = depth
    pipe = timit.build_featurizer(config, device).and_then(auto, sld.data, sld.labels)
    _sync(device)
    baseline = torch.cuda.memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    fitted = pipe.fit()
    _sync(device)
    seconds = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    grown = (torch.cuda.max_memory_allocated() - baseline) if device == "cuda" else 0
    PipelineEnv.get_or_create().reset()
    return fitted, auto, seconds, counts, grown


def _disk_tile_kernels(cuda_ops, shards, bank, device):
    """Phase 21(a)'s kernels against their plain versions at the shapes the
    disk fold gives them, phase 1's tolerances: ``cosine_features`` on a
    full tile and on the last segment's tile (8,192 rows each, the last
    zero-padded past its 4,544 true rows), ``gram_sym_acc`` in place on
    each tile's true rows of those features (8,192 and 4,544 x 16,384).
    Returns the errors by tile."""
    d = bank.Wrf.shape[0]
    gen = torch.Generator(device=device).manual_seed(21)
    G0 = torch.randn((d, d), generator=gen, device=device)
    tiles = torch.arange(d, device=device) // 128
    upper = tiles[:, None] <= tiles[None, :]
    errs = {}
    last = DISK_TILES - 1
    for label, tile in (("full", 0), ("ragged", last)):
        X_seg, valid = shards.segment_source_x(tile // DISK_TPS)
        t = tile % DISK_TPS
        rows = min(int(valid) - t * DISK_TILE, DISK_TILE)
        X_t = torch.from_numpy(np.array(X_seg[t])).to(device)
        F = cuda_ops.cosine_features(X_t, bank.Wrf, bank.brf)
        want = cuda_ops.cosine_features_ref(X_t, bank.Wrf, bank.brf)
        _sync(device)
        cos_err = (F - want).abs().max().item()
        check(f"21(a) cosine_features on the {label} tile, {X_t.shape[0]}x{X_t.shape[1]} @ "
              f"{d}x{bank.Wrf.shape[1]}", cos_err <= 1e-5,
              f"max_abs_err {cos_err:.3e} (tol 1e-5)")
        del want
        Fv = F[:rows]
        want = cuda_ops.gram_sym_acc_ref(G0, Fv)
        G = G0.clone()
        cuda_ops.gram_sym_acc(G, Fv, out=G)
        _sync(device)
        # Relative to the scale of the sums, as phase 1.
        scale = torch.addmm(G0.abs(), Fv.abs().T, Fv.abs())
        diff = (G - want).abs()
        gram_err = diff[upper].max().item()
        rel = (diff / scale)[upper].max().item()
        check(f"21(a) gram_sym_acc in place on the {label} tile, G0 {d}x{d}, F {rows}x{d}",
              rel <= 1e-4 and (torch.device(device).type != "cuda"
                               or torch.equal(G[~upper], G0[~upper])),
              f"upper tiles max_abs_err {gram_err:.3e} ({rel:.2e} of scale), tol 1e-4 of "
              "scale, lower tiles untouched")
        errs[label] = dict(rows=rows, cosine_max_abs_err=cos_err, gram_max_abs_err=gram_err,
                           gram_rel_err=rel)
        del F, Fv, want, G, scale, diff
    del G0, upper
    return errs


def phase_disk_timit(cuda_ops, timit, TimitConfig, root, smi, device="cuda"):
    """Phase 21(a): TIMIT written to disk shards and fitted from them
    through the Pipeline API at depth 2 and 0."""
    from keystone_tpu_torch.data.prefetch import PrefetchStats
    from keystone_tpu_torch.data.shards import DiskDenseShardWriter
    from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize
    from keystone_tpu_torch.parallel import streaming
    from keystone_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    writer = DiskDenseShardWriter(os.path.join(root, "timit"), capacity_rows=DISK_N, d_in=D_IN,
                                  k=K, tile_rows=DISK_TILE, tiles_per_segment=DISK_TPS)
    for X, Y, _ in disk_row_blocks(DISK_N, 1, device):
        writer.append(X.cpu().numpy(), Y.cpu().numpy())
    shards = writer.close()
    sld = shards.as_labeled_data()
    write_s = time.perf_counter() - t0
    disk_bytes = sum(os.path.getsize(os.path.join(shards.directory, f))
                     for f in os.listdir(shards.directory))
    log(f"  (a) {DISK_N} x {D_IN} rows, {K} classes: {shards.num_tiles} tiles of {DISK_TILE} "
        f"({DISK_RAGGED} rows in the last), {shards.num_segments} segments, {disk_bytes} bytes "
        f"of shards written and checksummed in {write_s:.3f} s")
    check("21(a) the shard geometry", shards.num_tiles == DISK_TILES
          and shards.num_segments == DISK_SEGMENTS and shards.n_true == DISK_N,
          f"{shards.num_tiles} tiles, {shards.num_segments} segments, {shards.n_true} rows")
    runs = {}
    for depth in (2, 0):
        fitted, auto, seconds, counts, grown = _disk_fit(cuda_ops, timit, TimitConfig, sld, depth,
                                                         device)
        decision = auto.last_decision
        (priced,) = [c["resident_bytes"] for c in decision["candidates"]
                     if c["label"] == "StreamingLeastSquaresChoice"]
        model = _streamed_model(fitted)
        runs[depth] = dict(fitted=fitted, model=model, seconds=seconds, launches=counts,
                           grown=grown, priced=priced, decision=decision,
                           center=auto._streaming_choice.center)
        log(f"  (a) depth {depth}: fit {seconds:.3f} s, winner {decision['winner']} "
            f"(shard_backed {decision['context']['shard_backed']}), launches "
            f"{ {k: v for k, v in counts.items() if v} }, "
            f"run peak {grown} B against the priced {priced:.6g} B ({smi})")
        check(f"21(a) depth {depth}: the selector picks the disk tier",
              decision["winner"] == "StreamingLeastSquaresChoice"
              and decision["context"]["shard_backed"] is True
              and all(not c["feasible"] for c in decision["candidates"]
                      if c["label"] != "StreamingLeastSquaresChoice"),
              f"winner {decision['winner']}, candidates {decision['candidates']}")
        check(f"21(a) depth {depth}: gram_sym_acc once a tile, cosine_features every tile",
              counts["gram_sym_acc"] == DISK_TILES and counts["cosine_features"] >= DISK_TILES,
              f"{counts['gram_sym_acc']} and {counts['cosine_features']} launches, "
              f"{DISK_TILES} tiles")
        if device == "cuda":
            check(f"21(a) depth {depth}: the run's peak within "
                  f"{DISK_PEAK_OVER_PRICED:.0%} over the priced resident bytes",
                  grown <= (1 + DISK_PEAK_OVER_PRICED) * priced,
                  f"{grown / 2**30:.3f} GiB <= {(1 + DISK_PEAK_OVER_PRICED) * priced / 2**30:.3f} GiB")
    on, off = runs[2]["model"], runs[0]["model"]
    check("21(a) depth 0 and depth 2 give bit-equal weights",
          torch.equal(on.W_stack, off.W_stack) and torch.equal(on.fmean, off.fmean)
          and torch.equal(on.ymean, off.ymean), "W, fmean, ymean bitwise equal")
    # A resident streamed fit of the same rows (the fit's own cosine bank),
    # and held-out predictions.
    bank = on.featurize
    check("21(a) the fit folded through the cosine bank", isinstance(bank, CosineBankFeaturize),
          f"featurize {type(bank).__name__}")
    # The overlap reading: the same fold over the shards, called with a
    # PrefetchStats at depth 2, after the Pipeline's fits.
    for depth in (2, 0):
        stats = PrefetchStats()
        _sync(device)
        t0 = time.perf_counter()
        W, fmean, ymean, _ = streaming.streaming_bcd_fit_segments(
            shards.as_source(), bank=bank, d_feat=NUM_COSINES * BLOCK,
            block_size=int(on.W_stack.shape[1]), lam=DISK_LAM, num_iter=EPOCHS,
            center=runs[depth]["center"], prefetch_depth=depth, prefetch_stats=stats,
            device=device)
        _sync(device)
        r = runs[depth]
        r.update(fold_seconds=time.perf_counter() - t0,
                 overlap=profiling.prefetch_overlap_fraction(stats),
                 report=profiling.overlap_report(stats), load_s=stats.load_s,
                 wait_s=stats.wait_s, retries=profiling.prefetch_retry_counters(stats))
        log(f"  (a) depth {depth}, the fold called directly: {r['fold_seconds']:.3f} s, overlap "
            f"{r['overlap']}, load {stats.load_s:.3f} s, wait {stats.wait_s:.3f} s, sites "
            f"{r['report']} ({smi})")
        check(f"21(a) depth {depth}: the fold called directly gives the Pipeline fit's bits",
              torch.equal(W, r["model"].W_stack) and torch.equal(fmean, r["model"].fmean)
              and torch.equal(ymean, r["model"].ymean), "W, fmean, ymean bitwise equal")
        del W, fmean, ymean
    tile_errs = _disk_tile_kernels(cuda_ops, shards, bank, device)
    X_all, Y_all = [], []
    for X, Y, _ in disk_row_blocks(DISK_N, 1, device):
        X_all.append(X)
        Y_all.append(Y)
    X_all, Y_all = torch.cat(X_all), torch.cat(Y_all)
    from keystone_tpu_torch.data import Dataset

    # Resident --solver streaming fits of the same rows: at its default
    # tiles (32,768 rows), and at the shards' 8,192-row tiles, where it sums
    # the rows in the disk fold's order.
    residents = {}
    for tile in (None, DISK_TILE):
        t0 = time.perf_counter()
        est = timit_streaming_estimator(bank, tile)
        fit = est.fit(Dataset(X_all), Dataset(Y_all))
        _sync(device)
        residents[tile] = (fit, est.tile_rows, time.perf_counter() - t0)
    del X_all, Y_all
    X_test = torch.cat([X for X, _, _ in disk_row_blocks(DISK_TEST, 2, device)])
    cuda_ops.reset_launch_counts()
    got = runs[2]["fitted"].apply(Dataset(X_test)).to_numpy()
    apply_counts = dict(cuda_ops.launches)
    gaps = {}
    for tile, (fit, tile_rows, resident_s) in residents.items():
        want = fit.batch_apply(Dataset(X_test)).to_numpy()
        gap = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
        same_bits = bool(np.array_equal(got, want))
        gaps[tile] = dict(tile_rows=tile_rows, resident_fit_seconds=resident_s,
                          heldout_gap=gap, heldout_bit_equal=same_bits)
        log(f"  (a) resident streamed fit of the same rows at {tile_rows}-row tiles "
            f"{resident_s:.3f} s; held-out {DISK_TEST} rows: max |disk - resident| / "
            f"(1 + |resident|) = {gap:.3e} (bit-equal {same_bits}) ({smi})")
    log(f"  (a) held-out apply launches { {k: v for k, v in apply_counts.items() if v} }")
    check("21(a) held-out predictions within 5e-4 of the resident --solver streaming fit",
          gaps[None]["heldout_gap"] <= 5e-4,
          f"{gaps[None]['heldout_gap']:.3e} at {gaps[None]['tile_rows']}-row tiles")
    check("21(a) held-out predictions bit-equal to a resident fit folding the disk's tiles",
          gaps[DISK_TILE]["heldout_bit_equal"],
          f"{gaps[DISK_TILE]['heldout_gap']:.3e} at {DISK_TILE}-row tiles")
    check("21(a) the fitted model predicts through cosine_features and row_stable_matmul",
          apply_counts["cosine_features"] > 0 and apply_counts["row_stable_matmul"] > 0,
          f"{apply_counts}")
    summary = {
        "rows": DISK_N, "tiles": DISK_TILES, "segments": DISK_SEGMENTS,
        "shard_bytes": disk_bytes, "write_seconds": write_s,
        "resident": {str(tile or "default"): g for tile, g in gaps.items()},
        "tile_kernels": tile_errs,
        "apply_launches": {k: v for k, v in apply_counts.items() if v},
    }
    for depth, r in runs.items():
        summary[f"depth_{depth}"] = dict(
            fit_seconds=r["seconds"], fold_seconds=r["fold_seconds"],
            overlap_fraction=r["overlap"], load_seconds=r["load_s"],
            wait_seconds=r["wait_s"], sites=r["report"], retries=r["retries"],
            launches={k: v for k, v in r["launches"].items() if v},
            run_peak_bytes=r["grown"], priced_resident_bytes=r["priced"],
            run_peak_over_priced=(r["grown"] / r["priced"]) if r["priced"] else None)
    return summary, runs[2]["launches"], sld, bank, on


def timit_streaming_estimator(bank, tile_rows=DISK_TILE):
    """--solver streaming's estimator at phase 21's geometry, folding tiles
    of ``tile_rows`` rows (None: its default). At the shards' 8,192 rows it
    sums the rows in the disk fold's order and gives the disk fit's bits;
    at other tiles the two part by float32 rounding."""
    from keystone_tpu_torch.ops.learning.streaming_ls import StreamingFeaturizedLeastSquares

    return StreamingFeaturizedLeastSquares(bank, d_feat=NUM_COSINES * BLOCK, block_size=BLOCK,
                                           num_iter=EPOCHS, lam=DISK_LAM, tile_rows=tile_rows)


def phase_disk_resume(cuda_ops, sld, bank, want, root, smi, device="cuda"):
    """Phase 21(b): the disk fold killed by a read fault, resumed from its
    checkpoint to the uninterrupted fit's bits."""
    from keystone_tpu_torch.data.durable import CheckpointSpec
    from keystone_tpu_torch.ops.learning import streaming_ls
    from keystone_tpu_torch.parallel import streaming
    from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule

    ck = CheckpointSpec(os.path.join(root, "ck"), every_segments=DISK_CKPT_EVERY)

    def fit():
        return streaming.streaming_bcd_fit_segments(
            streaming_ls._paired_source(sld.data, sld.labels), bank=bank,
            d_feat=NUM_COSINES * BLOCK, block_size=BLOCK, lam=DISK_LAM, num_iter=EPOCHS,
            prefetch_depth=2, checkpoint=ck)

    kill = FaultPlan([FaultRule("prefetch.read", "error",
                                calls=[DISK_KILL_SEGMENT, DISK_KILL_SEGMENT + 1,
                                       DISK_KILL_SEGMENT + 2])])
    t0 = time.perf_counter()
    try:
        with kill:
            fit()
        killed = False
    except OSError:
        killed = True
    killed_s = time.perf_counter() - t0
    snapshot = ck.has_snapshot()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    W, fmean, ymean, _ = fit()
    _sync(device)
    resumed_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    resumed_tiles = DISK_TILES - (DISK_KILL_SEGMENT // DISK_CKPT_EVERY) * DISK_CKPT_EVERY * DISK_TPS
    log(f"  (b) killed at segment {DISK_KILL_SEGMENT} after {killed_s:.3f} s (snapshots every "
        f"{DISK_CKPT_EVERY} segments); resumed in {resumed_s:.3f} s, gram_sym_acc "
        f"{counts['gram_sym_acc']} launches ({smi})")
    check("21(b) the killed fit left a snapshot and the resumed fit has the uninterrupted bits",
          killed and snapshot and torch.equal(W, want.W_stack) and torch.equal(fmean, want.fmean)
          and torch.equal(ymean, want.ymean) and not ck.has_snapshot(),
          f"killed {killed}, snapshot {snapshot}, W / fmean / ymean bitwise equal to (a)")
    check("21(b) the resumed fold folded only the segments after its snapshot",
          counts["gram_sym_acc"] == resumed_tiles,
          f"{counts['gram_sym_acc']} launches, {resumed_tiles} tiles after the snapshot")
    return dict(killed_seconds=killed_s, resumed_seconds=resumed_s,
                resumed_launches={k: v for k, v in counts.items() if v})


def phase_disk_sparse(cuda_ops, w_true, bf16_w1, root, smi, device="cuda"):
    """Phase 21(c): phase 8's Amazon rows from DiskCOOShards through the
    segment-source fold at depth 2 and 0, then a killed and resumed
    segmented fold under KEYSTONE_CHECKPOINT_DIR."""
    from keystone_tpu_torch.data.prefetch import PrefetchStats
    from keystone_tpu_torch.data.shards import DiskCOOShards
    from keystone_tpu_torch.ops.learning.lbfgs import _resident_chunk_fn, run_lbfgs_gram_streamed
    from keystone_tpu_torch.utils import profiling
    from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule

    n, d, nnz, k = AMAZON_N, AMAZON_D, AMAZON_NNZ, AMAZON_K
    t0 = time.perf_counter()
    idx, vals, _, Y = amazon_rows(n, d, nnz, k, 1, w_true)
    # The gram engine's intercept lane: column d, value 1.
    idx1 = np.concatenate([idx, np.full((n, 1), d, np.int32)], axis=1)
    val1 = np.concatenate([vals, np.ones((n, 1), np.float32)], axis=1)
    shards = DiskCOOShards.write(os.path.join(root, "amazon"), idx1, val1, Y,
                                 chunk_rows=AMAZON_CHUNK, n_true=n, d=d + 1)
    write_s = time.perf_counter() - t0
    runs = {}
    for depth in (2, 0):
        stats = PrefetchStats()
        cuda_ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        W, loss = run_lbfgs_gram_streamed(
            _resident_chunk_fn, shards.num_chunks, d + 1, k, lam=AMAZON_LAM,
            num_iterations=AMAZON_ITERS, n=n, val_dtype=torch.bfloat16,
            segment_source=shards.as_source(DISK_COO_CPS), prefetch_depth=depth,
            prefetch_stats=stats, device=device)
        _sync(device)
        runs[depth] = dict(W=W, loss=loss, seconds=time.perf_counter() - t0,
                           launches=dict(cuda_ops.launches),
                           overlap=profiling.prefetch_overlap_fraction(stats))
        log(f"  (c) depth {depth}: fit {runs[depth]['seconds']:.3f} s, loss {float(loss):.7f}, "
            f"overlap {runs[depth]['overlap']}, gram_corr_sym_acc "
            f"{runs[depth]['launches']['gram_corr_sym_acc']} launches ({smi})")
    a, b = runs[2], runs[0]
    check("21(c) depth 0 and depth 2 give bit-equal weights",
          torch.equal(a["W"], b["W"]) and torch.equal(a["loss"], b["loss"]), "bitwise equal")
    check("21(c) gram_corr_sym_acc once a chunk",
          a["launches"]["gram_corr_sym_acc"] == AMAZON_CHUNKS
          and b["launches"]["gram_corr_sym_acc"] == AMAZON_CHUNKS,
          f"{a['launches']['gram_corr_sym_acc']} and {b['launches']['gram_corr_sym_acc']}, "
          f"{AMAZON_CHUNKS} chunks")
    resident_equal = bf16_w1 is not None and torch.equal(a["W"], bf16_w1)
    rel = (float((a["W"] - bf16_w1).norm() / bf16_w1.norm()) if bf16_w1 is not None
           else float("nan"))
    log(f"  (c) against phase 8's resident bf16 gram engine: bitwise equal {resident_equal}, "
        f"relative difference {rel:.3e}")
    check("21(c) the disk fold has the bits of phase 8's resident gram engine (same chunk ids)",
          resident_equal, f"relative difference {rel:.3e}")
    # A segmented fold under KEYSTONE_CHECKPOINT_DIR, killed and resumed.
    saved = {key: os.environ.get(key) for key in
             ("KEYSTONE_CHECKPOINT_DIR", "KEYSTONE_CHECKPOINT_EVERY", "KEYSTONE_CHECKPOINT_SYNC")}
    os.environ.update(KEYSTONE_CHECKPOINT_DIR=os.path.join(root, "ck-coo"),
                      KEYSTONE_CHECKPOINT_EVERY="2", KEYSTONE_CHECKPOINT_SYNC="1")
    try:
        def fit():
            return run_lbfgs_gram_streamed(
                _resident_chunk_fn, shards.num_chunks, d + 1, k, lam=AMAZON_LAM,
                num_iterations=AMAZON_ITERS, n=n, val_dtype=torch.bfloat16,
                segment_source=shards.as_source(DISK_COO_CPS), device=device)

        try:
            with FaultPlan([FaultRule("prefetch.read", "error", calls=[3, 4, 5])]):
                fit()
            killed = False
        except OSError:
            killed = True
        cuda_ops.reset_launch_counts()
        W_r, loss_r = fit()
        resumed_launches = cuda_ops.launches["gram_corr_sym_acc"]
        left = os.listdir(os.environ["KEYSTONE_CHECKPOINT_DIR"])
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    check("21(c) the segmented fold under KEYSTONE_CHECKPOINT_DIR resumes to the same bits",
          killed and torch.equal(W_r, a["W"]) and torch.equal(loss_r, a["loss"])
          and resumed_launches == AMAZON_CHUNKS - 2 * DISK_COO_CPS and left == [],
          f"killed {killed}, resumed with {resumed_launches} launches, bitwise equal, "
          f"directory left {left}")
    return dict(write_seconds=write_s, resident_bits_equal=resident_equal,
                resident_relative_difference=rel,
                **{f"depth_{dd}": dict(fit_seconds=r["seconds"], overlap_fraction=r["overlap"],
                                       final_loss=float(r["loss"]))
                   for dd, r in runs.items()}), a["launches"]


def phase_disk_spill(root, smi, device="cuda"):
    """Phase 21(d): the CSV spill path and the image loader's spill tier."""
    from keystone_tpu_torch.data.images import SyntheticEncodedImages, load_images
    from keystone_tpu_torch.data.loaders import csv_to_disk_shards
    from keystone_tpu_torch.data.prefetch import iter_segments, stage_segment, to_device_segment

    # CSV: values on a 1/1024 grid (exact in float32), written fast by table.
    rng = np.random.default_rng(21)
    codes = rng.integers(-8192, 8192, size=(DISK_CSV_N, D_IN))
    labels = rng.integers(0, K, size=DISK_CSV_N)
    table = np.array([repr(v / 1024) for v in range(-8192, 8192)], dtype=object)
    t0 = time.perf_counter()
    path = os.path.join(root, "timit.csv")
    with open(path, "w") as f:
        for lab, row in zip(labels, table[codes + 8192]):
            f.write(str(lab) + "," + ",".join(row) + "\n")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sld = csv_to_disk_shards(path, os.path.join(root, "csv"), shard_rows=DISK_TILE,
                             tiles_per_segment=DISK_TPS, num_classes=K)
    spill_s = time.perf_counter() - t0
    X = sld.data.to_numpy()
    Y = sld.labels.to_numpy()
    err = float(np.abs(X - codes / 1024.0).max())
    check("21(d) the CSV spill round-trips rows within 1e-5 and labels exactly",
          sld.data.n == DISK_CSV_N and err <= 1e-5
          and np.array_equal(Y, 2.0 * np.eye(K, dtype=np.float32)[labels] - 1.0),
          f"{sld.data.n} rows, max row error {err:.3e}")
    # Images: VOC's count at phase 15's size, a budget that forces the spill.
    provider = SyntheticEncodedImages(DISK_IMAGES, x=DISK_IMAGE_SIZE, y=DISK_IMAGE_SIZE,
                                      channels=3, num_classes=20, seed=7)
    d = DISK_IMAGE_SIZE * DISK_IMAGE_SIZE * 3
    # Three staged segments fit the budget; the uint8 resident rows do not.
    budget = 3 * DISK_IMAGE_SEGMENT * (4.0 * d + 80) + 1.0
    t0 = time.perf_counter()
    spilled, tier, _ = load_images(provider, images_per_segment=DISK_IMAGE_SEGMENT,
                                   spill_dir=os.path.join(root, "images"),
                                   host_budget_bytes=budget, tile_rows=256)
    image_spill_s = time.perf_counter() - t0
    resident, rtier, _ = load_images(provider, host_budget_bytes=1e12)
    want = torch.from_numpy(resident.data.to_numpy()).to(device)
    side = torch.cuda.Stream() if device == "cuda" else None
    got = []
    t0 = time.perf_counter()
    for _, staged in iter_segments(spilled.data.shard_source, prefetch_depth=2,
                                   stage=lambda p: stage_segment(p, device)):
        got.append(to_device_segment(staged, device, side))
    _sync(device)
    prefetch_s = time.perf_counter() - t0
    got = torch.cat(got)[:DISK_IMAGES]
    check("21(d) the image set spills (uint8 on disk) and its prefetched rows on the card equal "
          "the resident decode", tier == "disk_shards" and rtier == "resident"
          and got.dtype == torch.uint8 and torch.equal(got.to(torch.float32), want),
          f"tiers {tier} and {rtier}, {tuple(got.shape)} {got.dtype}")
    log(f"  (d) CSV {DISK_CSV_N} x {D_IN} written {write_s:.3f} s, spilled to shards "
        f"{spill_s:.3f} s (native parse); {DISK_IMAGES} images spilled in {image_spill_s:.3f} s, "
        f"prefetched onto the card in {prefetch_s:.3f} s ({smi})")
    return dict(csv_write_seconds=write_s, csv_spill_seconds=spill_s,
                image_spill_seconds=image_spill_s, image_prefetch_seconds=prefetch_s)


ZOO = "zoo and autoscaler: weight paging under a device budget, fair admission, the SLO loop"
# 22(a): 6 tenants (pickle clones of phase 19's fits, seeds 0 and 1 in
# turn) under a budget of 3 tenants' charge, 40 requests a tenant in turn,
# two rounds; 3 page-ins timed against another tenant's closed loop.
ZOO_TENANTS, ZOO_FIT, ZOO_REQUESTS, ZOO_ROUNDS, ZOO_STALLS = 6, 3, 40, 2, 3
# 22(b): the reference's isolation drill with TIMIT plans.
ZOO_ISO_TENANTS, ZOO_ISO_BASE_HZ, ZOO_ISO_HOT_X, ZOO_ISO_S = 8, 25.0, 80, 2.5
# 22(d): run.py serve at MnistRandomFFT's defaults, 4 tenants at 10 Hz each.
ZOO_CLI_RATE, ZOO_CLI_S = 40.0, 2.0
# 22(e): the autoscaler on one plan at batch size 1 (a replica's capacity
# is then one replay a request), between 1 and 3 replicas.
AUTO_MAX_REPLICAS, AUTO_CAP_BURST, AUTO_HIGH_S, AUTO_LOW_LEG_S, AUTO_LOW_MAX_S = 3, 3000, 3.0, 1.0, 20.0
AUTO_COOLDOWN_S = 0.3


def _zoo_sync(device):
    """Allocated device bytes after a synchronize (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()
    return 0


def _zoo_plan(blob, max_batch, device):
    import pickle

    from keystone_tpu_torch.serving import export_plan

    return export_plan(pickle.loads(blob), np.zeros(D_IN, np.float32), max_batch=max_batch,
                       device=device)


def _plan_offline(plan, rows, device):
    """The plan's fused graph applied to ``rows`` as one batch (19(a)'s
    reference for served rows)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.workflow import FittedPipeline

    return FittedPipeline(plan.graph, plan.source, plan.sink).apply(
        Dataset(torch.from_numpy(rows).to(device))).array.cpu().numpy()


def _closed_loop(submit, x, stop, out):
    """Submit ``x`` and wait, again and again, until ``stop`` is set;
    ``out`` gets (start, end) of each request."""
    while not stop.is_set():
        t0 = time.perf_counter()
        submit(x).result(timeout=120)
        out.append((t0, time.perf_counter()))


def phase_zoo_paging(cuda_ops, blobs, pool, smi, device="cuda"):
    """22(a): paging under a budget of 3 of 6 TIMIT tenants."""
    import gc
    import threading

    from keystone_tpu_torch.serving import ModelZoo

    cuda = torch.device(device).type == "cuda"
    rows = pool[:ZOO_REQUESTS]
    # What one pickle clone holds on the card once exported (its tensors as
    # unpickled, its bucket programs); a resident tenant's own footprint is
    # read below from what a page-out frees once the tenant has been paged
    # in (its weights then as the zoo uploads them).
    gc.collect()
    m0 = _zoo_sync(device)
    plans = {"z0": _zoo_plan(blobs[0], SERVE_MAX_BATCH, device)}
    m1 = _zoo_sync(device)
    charge = plans["z0"].pinned_bytes
    for i in range(1, ZOO_TENANTS):
        plans[f"z{i}"] = _zoo_plan(blobs[i % 2], SERVE_MAX_BATCH, device)
    buckets = len(plans["z0"].buckets)
    offline = [_plan_offline(plans[f"z{s}"], rows, device) for s in (0, 1)]
    fps = [plans["z0"].fingerprint, plans["z1"].fingerprint]
    check("22(a) the two seeds' plans differ (fingerprints and rows)",
          fps[0] != fps[1] and not np.array_equal(offline[0], offline[1]),
          f"fingerprints {fps}")
    zoo = ModelZoo(budget_bytes=ZOO_FIT * charge + ZOO_FIT, max_batch=SERVE_MAX_BATCH,
                   max_wait_ms=2.0)
    page_out = dict(s=[], freed=[])
    inner = zoo._page_out_locked

    def timed_page_out(entry, reason):
        mb = _zoo_sync(device)
        t0 = time.perf_counter()
        inner(entry, reason)
        page_out["s"].append(time.perf_counter() - t0)
        page_out["freed"].append((entry.page_ins, mb - _zoo_sync(device)))

    zoo._page_out_locked = timed_page_out
    rng = np.random.default_rng(22)
    names = sorted(plans)
    try:
        for name in names:
            zoo.add_tenant(name, plans.pop(name))
        cuda_ops.reset_launch_counts()
        replays, mem, worst, bits = 0, [], 0.0, True
        for r in range(ZOO_ROUNDS):
            for i, name in enumerate(names):
                entry = zoo._tenants[name]
                before = entry.plan
                start = sum(before.replays.values()) if before is not None else 0
                futures = []
                for k in range(ZOO_REQUESTS):
                    futures.append(zoo.submit(name, rows[k]))
                    time.sleep(float(rng.uniform(0.0, 0.004)))
                served = np.stack([f.result(timeout=120) for f in futures])
                if entry.plan is not before:
                    start = 0
                replays += sum(entry.plan.replays.values()) - start
                want = offline[i % 2]
                bits = bits and bool(np.array_equal(served, want))
                worst = max(worst, _row_rel(served, want))
            gc.collect()
            mem.append(_zoo_sync(device))
        stats = zoo.stats()
        launches = {k: v for k, v in cuda_ops.launches.items() if v}
        # The page-in stall: one resident tenant in a closed loop while 3
        # others page in (each recaptures its buckets).
        stall = []
        for k in range(ZOO_STALLS):
            hot = names[-1]
            cold = [n for n in names if not zoo._tenants[n].resident and n != hot][0]
            done, stop = [], threading.Event()
            th = threading.Thread(target=_closed_loop,
                                  args=(lambda x: zoo.submit(hot, x), rows[0], stop, done))
            th.start()
            time.sleep(0.3)
            t0 = time.perf_counter()
            zoo.page_in(cold)
            t1 = time.perf_counter()
            time.sleep(0.3)
            stop.set()
            th.join(timeout=120)
            inside = [e - s for s, e in done if s < t1 and e > t0]
            outside = [e - s for s, e in done if e <= t0 or s >= t1]
            stall.append(dict(page_in_s=t1 - t0, max_inside_ms=1e3 * max(inside, default=0.0),
                              median_outside_ms=1e3 * statistics.median(outside or [0.0]),
                              requests_inside=len(inside), requests=len(done)))
            zoo.page_in(hot)  # hot may have been the victim
        decisions = zoo.decision_log()
    finally:
        zoo.close()
    page_ins = [d["inputs"]["page_in_s"] for d in decisions if d["action"] == "page_in"]
    compression = sorted({d["inputs"]["compression"] for d in decisions
                          if d["action"] == "page_out" and d["ok"]})
    # A tenant paged in at least once holds its weights as uploaded; one
    # still on its pickle clone's tensors may hold more (a pickled view
    # carries its whole storage).
    freed = [b for n, b in page_out["freed"] if n > 0]
    per = {"cosine_features": NUM_COSINES, ROW_STABLE: 1} if cuda else {}
    rebuilt = stats["page_ins"] * buckets
    want = {k: v * (replays + rebuilt) for k, v in per.items()}
    out = dict(
        tenants=ZOO_TENANTS, budget_tenants=ZOO_FIT, charge_bytes=charge,
        clone_allocated_bytes=m1 - m0, resident_allocated_bytes=min(freed),
        allocated_over_charged=min(freed) / charge,
        page_ins=stats["page_ins"], page_outs=stats["page_outs"], replays=replays,
        page_in_s=dict(median=statistics.median(page_ins), max=max(page_ins)),
        page_out_s=dict(median=statistics.median(page_out["s"]), max=max(page_out["s"])),
        page_out_freed_bytes=[b for _, b in page_out["freed"]],
        compression=compression, mem_after_rounds=mem, stall=stall, launches=launches,
        bit_identical=bits, max_rel=worst, card=smi)
    log(f"  (a) {ZOO_TENANTS} tenants, budget {ZOO_FIT} x {charge} B: {json.dumps(out)}")
    check("22(a) the books balance, nothing quarantined, every fingerprint held",
          stats["accounting_ok"] and stats["quarantined"] == 0
          and all(t["fingerprint"] == fps[int(n[1:]) % 2] for n, t in stats["tenants"].items())
          and all(t["failed"] == 0 and t["rejected"] == 0 for t in stats["tenants"].values()),
          f"accounting_ok {stats['accounting_ok']}, quarantined {stats['quarantined']}")
    check("22(a) the budget binds: tenants paged in and out, at most 3 resident",
          stats["page_ins"] >= ZOO_TENANTS and stats["residents"] <= ZOO_FIT,
          f"page_ins {stats['page_ins']}, page_outs {stats['page_outs']}, "
          f"residents {stats['residents']}")
    check("22(a) served rows bit-identical to each tenant's offline apply across page round "
          "trips" if cuda else "22(a) served rows near each tenant's offline apply",
          bits if cuda else worst <= SERVE_TOL, f"bit identical {bits}, max relative {worst:.3e}")
    check("22(a) launches = launches a replay x (replays + page-ins x buckets rebuilt)",
          launches == want, f"{launches}, expected {want} ({replays} replays, {rebuilt} "
          "bucket programs rebuilt)")
    check("22(a) allocated memory does not grow across paging rounds",
          abs(mem[-1] - mem[0]) <= charge, f"{mem} (charge {charge})")
    check("22(a) a page-out frees at least the tenant's charge" if cuda else
          "22(a) page-outs timed",
          (min(b for _, b in page_out["freed"]) >= charge) if cuda else True,
          f"freed {page_out['freed']} (page-ins before each, bytes)")
    return out


def phase_zoo_isolation(blobs, pool, device="cuda"):
    """22(b): the reference chaos drill's shape with TIMIT plans: 8
    tenants, one hot at 80 x the base rate."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.serving import ModelZoo, run_multi_tenant_open_loop
    from keystone_tpu_torch.serving.batcher import frozen_heap

    names = [f"t{i}" for i in range(ZOO_ISO_TENANTS - 1)] + ["hot"]
    plans = {n: _zoo_plan(blobs[i % 2], 8, device) for i, n in enumerate(names)}
    charge = plans["hot"].pinned_bytes
    slos = {n: obs.SLOTracker([obs.SLOObjective("availability", kind="availability",
                                                target=0.95)]) for n in names}
    zoo = ModelZoo(budget_bytes=ZOO_ISO_TENANTS * charge + ZOO_ISO_TENANTS, max_batch=8,
                   max_wait_ms=10.0, tenant_queue_cap=8, max_outstanding_total=64)
    try:
        for n in names:
            zoo.add_tenant(n, plans.pop(n), slo=slos[n])
        rates = {n: ZOO_ISO_BASE_HZ for n in names}
        rates["hot"] = ZOO_ISO_BASE_HZ * ZOO_ISO_HOT_X
        with frozen_heap():  # this script owns the process's heap (C.14)
            report = run_multi_tenant_open_loop(
                zoo.submit, lambda tenant, i: pool[i % len(pool)], rates_hz=rates,
                duration_s=ZOO_ISO_S, seed=0, slos=slos)
        stats = zoo.stats()
    finally:
        zoo.close()
    states = report.tenant_states()
    row = report.to_row_dict()
    log(f"  (b) states {states}; hot {row['tenants']['hot']}; totals offered "
        f"{row['offered_total']}, rejected {row['rejected_total']}, failed {row['failed_total']}")
    others = [n for n in names if n != "hot"]
    check("22(b) the hot tenant leaves OK, rejected at its own door",
          states["hot"] in ("WARN", "BREACH") and report.tenants["hot"].rejected > 0,
          f"hot {states['hot']}, rejected {report.tenants['hot'].rejected}")
    check("22(b) every other tenant stays OK with 0 rejected and 0 failed",
          all(states[n] == "OK" and stats["tenants"][n]["rejected"] == 0
              and stats["tenants"][n]["failed"] == 0 for n in others),
          f"{ {n: (states[n], stats['tenants'][n]['rejected'], stats['tenants'][n]['failed']) for n in others} }")
    check("22(b) the books balance on the loadgen's side and the zoo's",
          report.accounting_ok() and stats["accounting_ok"], f"{row['accounting_ok']}")
    return dict(states=states, row=row)


def phase_zoo_cold_start(blobs, pool, device="cuda"):
    """22(c): a deadline below the page-in estimate fast-fails."""
    from keystone_tpu_torch.serving import ModelZoo, TenantColdStart

    plan = _zoo_plan(blobs[0], SERVE_MAX_BATCH, device)
    zoo = ModelZoo(budget_bytes=2 * plan.pinned_bytes, max_batch=SERVE_MAX_BATCH,
                   cold_start_estimate_s=0.0)
    try:
        zoo.add_tenant("cold", plan)
        zoo.page_out("cold")
        zoo.page_in("cold")  # measures the estimate
        zoo.page_out("cold")
        est = zoo.page_in_estimate_s()
        try:
            zoo.submit("cold", pool[0], deadline_ms=0.5 * est * 1e3)
            raised = None
        except TenantColdStart as e:
            raised = str(e)
        stats = zoo.stats()
    finally:
        zoo.close()
    log(f"  (c) page-in estimate {est:.4f} s; {raised}")
    check("22(c) a deadline of half the page-in estimate fast-fails with TenantColdStart",
          raised is not None and stats["coldstart_failfast"] == 1
          and not stats["tenants"]["cold"]["resident"] and stats["accounting_ok"],
          f"estimate {est:.4f} s, coldstart_failfast {stats['coldstart_failfast']}")
    return dict(page_in_estimate_s=est, coldstart_failfast=stats["coldstart_failfast"])


def phase_zoo_cli(cuda_ops, device="cuda"):
    """22(d): ``run.py serve --tenants 4`` under a budget of 2 tenants and
    ``serve --autoscale``, at MnistRandomFFT's defaults, in this process."""
    import contextlib
    import io

    from keystone_tpu_torch import run as cli
    from keystone_tpu_torch.workflow import PipelineEnv

    cuda = torch.device(device).type == "cuda"
    # One tenant's charge at the defaults: the block weights of 4 padded
    # FFT branches (4 x 512 features x 10 classes, plus 10 biases) and the
    # 4 branches' signs (784 each), float32.
    tenant_bytes = (4 * 512 * 10 + 10 + 4 * 784) * 4
    out = {}
    for label, extra in (
            ("tenants", ["--tenants", "4", "--zoo-budget-mb",
                         str(2.5 * tenant_bytes / (1 << 20)), "--rate", str(ZOO_CLI_RATE)]),
            ("autoscale", ["--autoscale", "--slo-p99-ms", "50", "--max-replicas", "3",
                           "--rate", "200"])):
        PipelineEnv.get_or_create().reset()
        cuda_ops.reset_launch_counts()
        argv = ["serve", "--duration-s", str(ZOO_CLI_S)] + extra + (
            [] if cuda else ["--device", "cpu"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches = {k: v for k, v in cuda_ops.launches.items() if v}
        PipelineEnv.get_or_create().reset()
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"  (d) serve {' '.join(extra)}: {json.dumps(summary)}; launches {launches}")
        if label == "tenants":
            books = summary["accounting_ok"] and all(
                t["num_offered"] == t["num_samples"] + t["rejected"] + t["failed"]
                for t in summary["per_tenant"].values())
            check("22(d) serve --tenants 4 under 2 tenants' budget: exit 0, per-tenant books "
                  "balance, the budget binds and pages",
                  rc == 0 and books and summary["page_ins"] > 0 and summary["residents"] <= 2
                  and set(summary["tenant_resident_bytes"].values()) == {tenant_bytes}
                  and summary["failed_total"] == 0 and summary["quarantined"] == 0,
                  f"rc {rc}, page_ins {summary['page_ins']}, residents {summary['residents']}, "
                  f"charges {summary['tenant_resident_bytes']}")
        else:
            books = summary["num_offered"] == (summary["num_samples"] + summary["rejected"]
                                               + summary["failed"])
            check("22(d) serve --autoscale: exit 0, books balance, none failed, inside the "
                  "replica bounds",
                  rc == 0 and books and summary["failed"] == 0
                  and 1 <= summary["replicas_low"] <= summary["replicas_high"] <= 3,
                  f"rc {rc}, replicas {summary['replicas_low']}..{summary['replicas_high']}")
        want = MNIST_LAUNCHES[True] if cuda else {}
        check(f"22(d) serve --{label}: the quick fit's launches",
              same_launches(launches, want), f"{launches}, expected {want}")
        out[label] = dict(summary=summary, launches=launches)
    return out


def _capacity(server, x, n):
    """Completions a second of ``n`` requests submitted back to back."""
    t0 = time.perf_counter()
    futures = [server.submit(x) for _ in range(n)]
    for f in futures:
        f.result(timeout=300)
    return n / (time.perf_counter() - t0)


def _lifo_ok(log_):
    stack = []
    for d in log_:
        if d["action"] == "brownout_enter":
            stack.append(d["step"])
        elif d["action"] == "brownout_exit":
            if not stack or stack.pop() != d["step"]:
                return False
    return not stack


def phase_autoscale(blobs, pool, smi, device="cuda"):
    """22(e): the autoscaler on a ReplicatedServer of phase 19's plan at
    batch size 1, a load step above one replica's capacity then well
    under it."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.serving import Autoscaler, ReplicatedServer, run_open_loop

    plan = _zoo_plan(blobs[0], SERVE_MAX_BATCH, device)
    kw = dict(max_batch=1, max_wait_ms=0.5, max_queue_depth=1 << 16, watchdog_interval_s=0.01)
    capacity = {}
    for n in range(1, AUTO_MAX_REPLICAS + 1):
        server = ReplicatedServer(plan, num_replicas=n, **kw)
        try:
            _capacity(server, pool[0], 200)
            capacity[n] = _capacity(server, pool[0], AUTO_CAP_BURST)
        finally:
            server.close()
    single_s = plan.measure_single_request_s()
    # The bound: well above the unloaded tail, far below a saturated queue.
    bound_s = max(20.0 * single_s, 0.005)
    slo = obs.SLOTracker([obs.SLOObjective(
        "latency", kind="latency", threshold_s=bound_s, target=0.9, fast_window_s=0.5,
        slow_window_s=2.0, breach_burn=4.0)])
    server = ReplicatedServer(plan, num_replicas=1, slo=slo, **kw)
    scaler = Autoscaler(server, slo, min_replicas=1, max_replicas=AUTO_MAX_REPLICAS,
                        tick_interval_s=0.02, scale_up_sustain_s=0.2, scale_down_sustain_s=0.5,
                        cooldown_s=AUTO_COOLDOWN_S, idle_queue_depth=2,
                        idle_outstanding_per_replica=1.0).start()
    legs = []
    try:
        high = 1.5 * capacity[1]
        legs.append(("high", run_open_loop(server.submit, lambda i: pool[i % len(pool)],
                                           rate_hz=high, duration_s=AUTO_HIGH_S, seed=31,
                                           slo=slo)))
        low = 0.1 * capacity[1]
        t_end = time.perf_counter() + AUTO_LOW_MAX_S
        seed = 32
        while True:
            legs.append(("low", run_open_loop(server.submit, lambda i: pool[i % len(pool)],
                                              rate_hz=low, duration_s=AUTO_LOW_LEG_S, seed=seed,
                                              slo=slo)))
            seed += 1
            sig = server.autoscale_signals()
            if (sig["replicas"] == 1 and sig["brownout_level"] == 0
                    and scaler.scale_downs > 0) or time.perf_counter() > t_end:
                break
    finally:
        scaler.close()
        server.close()
    decisions = scaler.decision_log()
    actions = [(d["action"], d.get("step"), d["t_s"]) for d in decisions]
    rows = [dict(leg=leg, **r.to_row_dict()) for leg, r in legs]
    st = scaler.stats()
    out = dict(capacity_qps=capacity, single_request_s=single_s, bound_s=bound_s,
               high_rate_hz=high, low_rate_hz=low, legs=rows, actions=actions,
               stats={k: v for k, v in st.items() if k != "decisions"}, card=smi)
    log(f"  (e) capacity by replicas {capacity} qps at batch size 1 ({smi}); actions {actions}")
    for r in rows:
        log(f"  (e) {r['leg']} {r['offered_rate_hz']} Hz: p50 {r['p50_latency_ms']} ms, p99 "
            f"{r['p99_latency_ms']} ms, offered {r['num_offered']}, completed "
            f"{r['num_samples']}, rejected {r['rejected']}, failed {r['failed']}")
    ups = [a for a in actions if a[0] == "scale_up"]
    first_down = next((i for i, a in enumerate(actions) if a[0] == "scale_down"), None)
    gaps = [b[2] - a[2] for a, b in zip(actions, actions[1:])]
    check("22(e) scale-up to max_replicas, brownout rungs entered and left LIFO, then "
          "scale-down to min_replicas",
          st["replicas_high"] == AUTO_MAX_REPLICAS and st["brownout_steps_entered"] >= 1
          and _lifo_ok(decisions) and first_down is not None
          and all(a[0] != "scale_up" for a in actions[first_down:])
          and st["replicas"] == 1 and st["brownout_level"] == 0
          and all(d["ok"] for d in decisions), f"{actions}")
    check(f"22(e) no two actions inside the {AUTO_COOLDOWN_S} s cooldown",
          all(g >= AUTO_COOLDOWN_S - 1e-6 for g in gaps), f"gaps {gaps}")
    check("22(e) every leg's books balance, none failed",
          all(r.num_offered == r.completed + r.rejected + r.failed and r.failed == 0
              for _, r in legs), f"{[(r['leg'], r['failed']) for r in rows]}")
    return out


CONTROL = ("control plane: the cost-weight sweep and refit, the selector on the card, the live "
           "exporter, the capacity planner")
# Phase 23. (a) the sweep: scripts/torch_fit_cost_weights.py's grid (None:
# the harness's own). (c) the selector at TIMIT's phase-11 rows and at phase
# 8's Amazon rows, and one streamed fit from disk shards: 32 tiles of 8,192
# rows, 2 a segment, under a 64 MiB host budget (every resident candidate
# infeasible). (d) serve runs of seconds at one rate, exporter on and off.
CONTROL_SWEEP = dict(dense_shapes=None, sparse_shapes=None)
CONTROL_STREAM_N, CONTROL_HOST_BUDGET = 262144, 64 << 20
CONTROL_SERVE_RATE, CONTROL_SERVE_S, CONTROL_SERVE_BATCH = 400.0, 3.0, 64


def _sweep_module():
    """scripts/torch_fit_cost_weights.py, the measurement harness."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_fit_cost_weights.py")
    spec = importlib.util.spec_from_file_location("torch_fit_cost_weights", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _CostFamily:
    """``KEYSTONE_COST_WEIGHTS`` set for a block, restored after."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        self.old = os.environ.get("KEYSTONE_COST_WEIGHTS")
        os.environ["KEYSTONE_COST_WEIGHTS"] = self.spec

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("KEYSTONE_COST_WEIGHTS", None)
        else:
            os.environ["KEYSTONE_COST_WEIGHTS"] = self.old


def _tool(main_fn, argv):
    """A tool's ``main`` run in this process: (exit code, its stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def _launch_delta(cuda_ops, before):
    return {k: v - before.get(k, 0) for k, v in cuda_ops.launches.items()
            if v - before.get(k, 0)}


def _solver_decisions(records):
    return [e for e in records if e.get("type") == "event" and e.get("name") == "cost.decision"
            and (e.get("args") or {}).get("decision") == "least_squares_solver"]


# Launches that phase 23 makes to hold a kernel against its plain version,
# taken out of the phase's main-path counts.
CONTROL_CHECK_LAUNCHES = {}


class _GramShapeLog:
    """Records the distinct operand shapes that ``gram_corr_sym`` and
    ``gram_corr_sym_acc`` receive while the block is open (the callers look
    the wrappers up on the module at each call)."""

    def __init__(self, cuda_ops):
        self.cuda_ops = cuda_ops
        self.shapes = {"gram_corr_sym": set(), "gram_corr_sym_acc": set()}

    def __enter__(self):
        self.orig = {name: getattr(self.cuda_ops, name) for name in self.shapes}
        sym, acc = self.orig["gram_corr_sym"], self.orig["gram_corr_sym_acc"]

        def gram_corr_sym(A, R):
            self.shapes["gram_corr_sym"].add((A.shape[0], A.shape[1], R.shape[1], A.dtype))
            return sym(A, R)

        def gram_corr_sym_acc(G, C, F, R, out=None):
            self.shapes["gram_corr_sym_acc"].add(
                (F.shape[0], F.shape[1], R.shape[1], F.dtype, F.stride(0)))
            return acc(G, C, F, R, out=out)

        self.cuda_ops.gram_corr_sym = gram_corr_sym
        self.cuda_ops.gram_corr_sym_acc = gram_corr_sym_acc
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cuda_ops, name, fn)


class _CheckLaunches:
    """Adds the launches made inside the block to CONTROL_CHECK_LAUNCHES."""

    def __init__(self, cuda_ops):
        self.cuda_ops = cuda_ops

    def __enter__(self):
        self.before = dict(self.cuda_ops.launches)

    def __exit__(self, *exc):
        for k, v in _launch_delta(self.cuda_ops, self.before).items():
            CONTROL_CHECK_LAUNCHES[k] = CONTROL_CHECK_LAUNCHES.get(k, 0) + v


def _hold_gram_corr_sym(cuda_ops, A, R, label):
    """``gram_corr_sym`` against its plain version at phase 1's tolerance:
    1e-4 of the sums' scale (the Gramian's largest diagonal entry; max over
    the correlation of sum |a||r|), and a symmetric Gramian."""
    with _CheckLaunches(cuda_ops):
        gram, corr = cuda_ops.gram_corr_sym(A, R)
    gram_r, corr_r = cuda_ops.gram_corr_sym_ref(A, R)
    _sync(A.device)
    g_err = (gram - gram_r).abs().max().item()
    c_err = (corr - corr_r).abs().max().item()
    g_rel = g_err / gram_r.diagonal().max().item()
    c_rel = c_err / (A.float().abs().T @ R.abs().to(torch.float32)).max().item()
    check(f"23 gram_corr_sym {label}", g_rel <= 1e-4 and c_rel <= 1e-4
          and torch.equal(gram, gram.T),
          f"gram max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err "
          f"{c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale, symmetric")
    return max(g_err, c_err)


def _hold_gram_corr_sym_acc(cuda_ops, G0, C0, F, R, label):
    """``gram_corr_sym_acc`` against its plain version at phase 1's and 8's
    tolerance, 1e-4 of the sums' scale (|G0| + sum |f_i||f_j| over the upper
    tiles, |C0| + sum |f||r|); in place it gives a new buffer's bits and
    leaves the lower tiles alone."""
    d1 = F.shape[1]
    tiles = torch.arange(d1, device=F.device) // 128
    upper = tiles[:, None] <= tiles[None, :]
    want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G0, C0, F, R)
    Ff = F.float()
    Rq = R.to(torch.bfloat16).float() if F.dtype == torch.bfloat16 else R.float()
    g_scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
    c_scale = torch.addmm(C0.abs(), Ff.abs().T, Rq.abs())
    del Ff, Rq
    G, C = G0.clone(), C0.clone()
    with _CheckLaunches(cuda_ops):
        fresh = cuda_ops.gram_corr_sym_acc(G0, C0, F, R)
        cuda_ops.gram_corr_sym_acc(G, C, F, R, out=(G, C))
    _sync(F.device)
    g_diff = (fresh[0] - want_g).abs()
    g_err = g_diff[upper].max().item()
    g_rel = g_diff.div_(g_scale)[upper].max().item()
    c_diff = (fresh[1] - want_c).abs()
    c_err, c_rel = c_diff.max().item(), (c_diff / c_scale).max().item()
    # (The plain version, which a CPU tensor takes, writes every tile.)
    same = F.device.type != "cuda" or (
        torch.equal(G[upper], fresh[0][upper]) and torch.equal(C, fresh[1])
        and torch.equal(G[~upper], G0[~upper]))
    check(f"23 gram_corr_sym_acc {label}", g_rel <= 1e-4 and c_rel <= 1e-4 and same,
          f"upper tiles max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err "
          f"{c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale; in place the bits of a "
          "new buffer, lower tiles untouched")
    return max(g_err, c_err)


def _sweep_shape_kernels(cuda_ops, shapes, device="cuda"):
    """23(a): each kernel against its plain version at every shape the sweep
    gave it, on seeded standard normal operands (the Gramian's columns
    centered, as a fit's are; a slab at the fold's row stride)."""
    gen = torch.Generator(device=device).manual_seed(23)
    errs = {}
    for n, d, k, dtype in sorted(shapes["gram_corr_sym"], key=str):
        A = torch.randn((n, d), generator=gen, device=device)
        A -= A.mean(dim=0)
        A = A.to(dtype)
        R = torch.randn((n, k), generator=gen, device=device)
        label = f"{str(dtype)[6:]} A {n}x{d}, R {n}x{k} (a sweep shape)"
        errs[label] = _hold_gram_corr_sym(cuda_ops, A, R, label)
        del A, R
    for rows, d1, k, dtype, stride in sorted(shapes["gram_corr_sym_acc"], key=str):
        F = torch.zeros((rows, stride), dtype=dtype, device=device)[:, :d1]
        F.copy_(torch.randn((rows, d1), generator=gen, device=device))
        R = torch.randn((rows, k), generator=gen, device=device)
        G0 = torch.randn((d1, d1), generator=gen, device=device)
        C0 = torch.randn((d1, k), generator=gen, device=device)
        label = (f"{str(dtype)[6:]} F {rows}x{d1} at row stride {stride}, R {rows}x{k} "
                 "(a sweep shape)")
        errs[label] = _hold_gram_corr_sym_acc(cuda_ops, G0, C0, F, R, label)
        del F, R, G0, C0
    torch.cuda.empty_cache()
    return errs


def _host_coo_rows(X, width):
    """The reference's per-row conversion (numpy): each row's nonzero
    columns in ascending order, then -1 lanes with zero values."""
    indices = np.full((X.shape[0], width), -1, dtype=np.int32)
    values = np.zeros((X.shape[0], width), dtype=np.float32)
    for i in range(X.shape[0]):
        nz = np.nonzero(X[i])[0]
        indices[i, :len(nz)] = nz
        values[i, :len(nz)] = X[i][nz]
    return indices, values


def _control_chunk_kernels(cuda_ops, timit, TimitConfig, root, device="cuda"):
    """23(c): what the selector's gram candidate runs on TIMIT's dense
    features (65,536 x 16,384, phase 11's rows and draws), checked at the
    fit's own shapes: ``Sparsify``'s conversion on the card (bit for bit
    against the reference's per-row numpy loop on the rows of the first
    and the last fold chunk), then ``gram_corr_sym_acc`` on the first chunk
    and on the last, padded one (float32 slabs of 16,385 columns, the
    intercept lane included, chunks of the lane cap's rows) against its
    plain version. Also prices the selector on these features, unfitted,
    into a trace of its own (23(e)'s planner input)."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.data.resident import raw_chunk_tiles
    from keystone_tpu_torch.ops import sparse
    from keystone_tpu_torch.ops.learning import lbfgs
    from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.workflow import PipelineEnv

    t0 = time.perf_counter()
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK, synthetic_n=N_TRAIN)
    train = synthetic_timit(N_TRAIN, seed=config.seed, device=device)
    F = timit.build_featurizer(config, device).apply(train.data).get().array
    Y = ClassLabelIndicatorsFromIntLabels(K)(train.labels).array
    PipelineEnv.get_or_create().reset()
    n, d = F.shape
    out = {}
    decisions_dir = os.path.join(root, "selector-priced")
    with _CostFamily("ec2"), obs.tracing(decisions_dir):
        LeastSquaresEstimator(lam=0.0, block_size=BLOCK, block_iters=EPOCHS).optimize(
            Dataset(F), Dataset(Y))
    out["decisions_dir"] = decisions_dir

    idx, val = sparse.padded_coo_rows(F)
    width = int((F != 0).sum(dim=1).max())
    d1 = d + 1
    c = min(lbfgs.SparseLBFGSwithL2().gram_chunk_rows, n,
            max(lbfgs._GRAM_CHUNK_LANES // (idx.shape[1] + 1), 1))
    nchunks = -(-n // c)
    last = n - (nchunks - 1) * c
    same = idx.shape[1] == width
    for lo, hi in ((0, c), (n - last, n)):
        want_i, want_v = _host_coo_rows(F[lo:hi].cpu().numpy(), width)
        same = (same and np.array_equal(idx[lo:hi].cpu().numpy(), want_i)
                and np.array_equal(val[lo:hi].cpu().numpy(), want_v))
    check(f"23(c) Sparsify on the card: padded_coo_rows of TIMIT's {n} x {d} features",
          same, f"width {idx.shape[1]} (densest row {width}); rows 0-{c - 1} and "
          f"{n - last}-{n - 1} bit for bit the reference's per-row loop")
    # The gram fit's operands (SparseLBFGSwithL2.fit, _fit_gram): the
    # intercept lane at column d, chunks of c rows, the tail padded.
    idx1 = torch.cat([idx, torch.full((n, 1), d, dtype=idx.dtype, device=device)], dim=1)
    val1 = torch.cat([val, torch.ones((n, 1), dtype=val.dtype, device=device)], dim=1)
    del idx, val
    idx_t, val_t, y_t = raw_chunk_tiles(idx1, val1, Y, c)
    del idx1, val1
    gen = torch.Generator(device=device).manual_seed(231)
    G0 = torch.randn((d1, d1), generator=gen, device=device)
    C0 = torch.randn((d1, K), generator=gen, device=device)
    align = sparse._SLAB_ROW_ALIGN[torch.float32]
    for label, cid, rows in (("first", 0, c), ("last, padded", nchunks - 1, last)):
        slab = sparse._dense_rows(idx_t[cid], val_t[cid], d1, torch.float32, align)
        out[label] = _hold_gram_corr_sym_acc(
            cuda_ops, G0, C0, slab, y_t[cid],
            f"f32 on the {label} fold chunk of TIMIT's dense rows: F {c}x{d1} ({rows} true "
            f"rows) at row stride {slab.stride(0)}, R {c}x{K}")
        del slab
    del F, Y, idx_t, val_t, y_t, G0, C0, train
    torch.cuda.empty_cache()
    out.update(chunk_rows=c, chunks=nchunks, seconds=time.perf_counter() - t0)
    log(f"  (c) TIMIT's dense rows in the gram fit's chunks: {nchunks} chunks of {c} rows "
        f"({last} true rows in the last), checked in {out['seconds']:.3f} s")
    return out


def phase_control_sweep(cuda_ops, root, device="cuda"):
    """23(a): the harness's sweep under obs.tracing, priced under ec2; then
    each kernel against its plain version at every shape the sweep gave
    it."""
    from keystone_tpu_torch import obs

    sw = _sweep_module()
    kw = {k: v for k, v in CONTROL_SWEEP.items() if v is not None}
    sweep_dir = os.path.join(root, "sweep")
    before = dict(cuda_ops.launches)
    t0 = time.perf_counter()
    with _CostFamily("ec2"), obs.tracing(sweep_dir), _GramShapeLog(cuda_ops) as shape_log:
        points = sw.run_sweep(device, log=lambda line: log(f"  (a) {line.strip()}"), **kw)
    launches = _launch_delta(cuda_ops, before)
    log(f"  (a) {len(points)} points in {time.perf_counter() - t0:.3f} s, launches {launches}")
    check("23(a) every sweep point measured after a synchronize",
          all(p["measured_s"] > 0 for p in points) and len(points) > 0,
          f"{len(points)} points")
    iters = {(p["engine"], p["n"]): p.get("iterations") for p in points
             if p["engine"].startswith("sparse")}
    log(f"  (a) L-BFGS iterations run (20 allowed): {iters}")
    check("23(a) every sparse point recorded its iterations",
          all(v is not None for v in iters.values()), f"{iters}")
    shapes = shape_log.shapes
    log(f"  (a) shapes given to gram_corr_sym {sorted(shapes['gram_corr_sym'], key=str)}, "
        f"gram_corr_sym_acc {sorted(shapes['gram_corr_sym_acc'], key=str)}")
    check("23(a) the block and gram points reached gram_corr_sym and bf16 and f32 "
          "gram_corr_sym_acc", launches.get("gram_corr_sym", 0) > 0
          and {s[3] for s in shapes["gram_corr_sym_acc"]} == {torch.float32, torch.bfloat16},
          f"{launches}")
    kernel_errs = _sweep_shape_kernels(cuda_ops, shapes, device)
    return dict(points=points, launches=launches, dir=sweep_dir, kernel_errs=kernel_errs)


def phase_control_calibrate(sweep, root):
    """23(b): tools.calibrate on the sweep's trace under ec2, --refit, then
    under the refit artifact."""
    from keystone_tpu_torch.tools import calibrate as cal_cli

    t0 = time.perf_counter()
    art = os.path.join(root, "art.json")
    runs = {}
    with _CostFamily("ec2"):
        for name, extra in (
                ("ec2", []),
                ("refit", ["--refit", art]),
                ("calibrated", ["--weights", f"calibrated:{art}"])):
            rc, out = _tool(cal_cli.main, [sweep["dir"], "--json"] + extra)
            doc = json.loads(out)
            runs[name] = dict(rc=rc, report=doc["report"], verdict=doc["verdict"],
                              refit=doc.get("refit"))
            v = doc["verdict"]
            log(f"  (b) tools.calibrate {' '.join(extra) or '(ec2)'}: rc {rc}, "
                f"{'DRIFT' if v['drifted'] else 'OK'}, median |log error| "
                f"{v['median_abs_log_error']}, worst {v['worst_engine']} "
                f"{v['worst_engine_median_abs_log_error']}")
    ec2 = runs["ec2"]["report"]
    for label, eng in sorted(ec2["per_engine"].items()):
        log(f"  (b) ec2 {label}: n {eng['count']}, median predicted "
            f"{eng['median_predicted_s']:.6g} s, measured {eng['median_measured_s']:.6g} s, "
            f"median log error {eng['median_log_error']:.4f}")
    weights = runs["refit"]["refit"]["weights"]
    log(f"  (b) refit weights: {json.dumps(weights)}")
    cal_report = runs["calibrated"]["report"]
    for label, eng in sorted(cal_report["per_engine"].items()):
        log(f"  (b) calibrated {label}: median log error {eng['median_log_error']:.4f}")
    check("23(b) calibration found data and joined every sweep point",
          all(r["rc"] != 3 for r in runs.values())
          and ec2["num_decisions"] == ec2["num_measured"] == len(sweep["points"]),
          f"rcs {[r['rc'] for r in runs.values()]}, {ec2['num_measured']} of "
          f"{ec2['num_decisions']} decisions measured, {len(sweep['points'])} points")
    before = ec2["median_abs_log_error"]
    after = cal_report["median_abs_log_error"]
    check("23(b) the refit's median |log error| on the sweep is below ec2's",
          after is not None and after < before, f"{after} < {before}")
    log(f"  (b) {time.perf_counter() - t0:.3f} s")
    return dict(runs=runs, weights=weights, artifact=art)


def _amazon_data(device):
    from keystone_tpu_torch.data import Dataset

    w_true = planted_model(AMAZON_D, 2)
    idx, vals, _, Y = amazon_rows(AMAZON_N, AMAZON_D, AMAZON_NNZ, AMAZON_K, 1, w_true)
    dev = torch.device(device)
    train = Dataset({"indices": torch.from_numpy(idx).to(dev),
                     "values": torch.from_numpy(vals).to(dev)}, n=AMAZON_N)
    return train, Dataset(torch.from_numpy(Y).to(dev))


# 23(c)'s tolerances: TIMIT's test error under either family within half a
# point of phase 11's (the card's fit against the CPU's in phase 2 is held
# there too); the Amazon weights within phase 8's bound of phase 8's fit by
# the same engine, 5e-3 of its gather model's largest weight.
CONTROL_TIMIT_ERR_TOL, CONTROL_AMAZON_W_TOL = 0.005, 5e-3
# Phase 8's engines by the selector's candidate labels.
CONTROL_AMAZON_ENGINES = {"SparseLBFGSwithL2[gather]": "gather",
                          "SparseLBFGSwithL2[gram]": "gram f32",
                          "SparseLBFGSwithL2[gram,int16_bf16]": "gram compressed int16+bf16"}


def phase_control_selector(cuda_ops, timit, TimitConfig, sweep, cal, refs, root,
                           device="cuda"):
    """23(c): the selector on the card under ec2 and under the refit: TIMIT
    at phase 11's rows (its test error held to phase 11's, ``refs
    ["timit_test_error"]``), the kernels at the shapes its gram candidate
    gives them there, the Amazon rows (the fitted weights held to phase 8's
    by the winning engine, ``refs["amazon"]``), and a streamed disk fit's
    span window beside its stamped outcome."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.data.shards import DiskDenseShardWriter
    from keystone_tpu_torch.obs import calibrate as calmod
    from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
    from keystone_tpu_torch.ops.sparse import Sparsify
    from keystone_tpu_torch.workflow import PipelineEnv

    families = {"ec2": "ec2", "calibrated": f"calibrated:{cal['artifact']}"}
    out = dict(timit={}, amazon={}, dirs={})
    before = dict(cuda_ops.launches)
    checks_before = dict(CONTROL_CHECK_LAUNCHES)
    for name, spec in families.items():
        PipelineEnv.get_or_create().reset()
        trace_dir = os.path.join(root, f"selector-timit-{name}")
        config = TimitConfig(solver="auto", num_cosines=NUM_COSINES, block_size=BLOCK,
                             synthetic_n=N_TRAIN, num_epochs=EPOCHS, lam=0.0)
        t0 = time.perf_counter()
        with _CostFamily(spec), obs.tracing(trace_dir) as tracer:
            result = timit.run(config, device=device)
            records = list(tracer.events)
        run_s = time.perf_counter() - t0
        PipelineEnv.get_or_create().reset()
        test_error = result.test_eval.total_error
        del result
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        (decision,) = _solver_decisions(records)
        args = decision["args"]
        outcome = args.get("outcome") or {}
        (priced,) = [c["cost_s"] for c in args["candidates"] if c["label"] == args["winner"]]
        fits = [r for r in records if r.get("type") == "span" and r["name"] == "estimator.fit"
                and r["span_id"] == outcome.get("span_id")]
        out["timit"][name] = dict(winner=args["winner"], predicted_s=priced,
                                  measured_s=outcome.get("measured_s"),
                                  timing=outcome.get("timing"), test_error=test_error)
        out["dirs"][f"timit-{name}"] = trace_dir
        log(f"  (c) TIMIT {N_TRAIN} x {D_IN} -> {NUM_COSINES} x {BLOCK} -> {K} under {name}: "
            f"winner {args['winner']}, predicted {priced} s, stamped {outcome.get('measured_s')} s "
            f"({outcome.get('timing')}), test error {100 * test_error:.3f}%, "
            f"run {run_s:.3f} s (data, fit, apply)")
        check(f"23(c) TIMIT under {name}: the decision carries its fit's stamped outcome",
              outcome.get("measured_s", 0) > 0 and outcome.get("timing") == "single_run_cold"
              and len(fits) == 1, f"outcome {outcome}, {len(fits)} linked estimator.fit span")
        check(f"23(c) TIMIT under {name}: test error within {CONTROL_TIMIT_ERR_TOL} of phase "
              "11's", abs(test_error - refs["timit_test_error"]) <= CONTROL_TIMIT_ERR_TOL,
              f"{100 * test_error:.3f}% against {100 * refs['timit_test_error']:.3f}%")
    out["chunks"] = _control_chunk_kernels(cuda_ops, timit, TimitConfig, root, device)
    t0 = time.perf_counter()
    train, labels = _amazon_data(device)
    log(f"  (c) Amazon rows made in {time.perf_counter() - t0:.3f} s")
    # The sweep's times of the selector's own engines (the bf16 gram point
    # is not one) at these rows.
    sparse_sweep = {p["label"]: p["measured_s"] for p in sweep["points"]
                    if p["engine"] in ("sparse-gather", "sparse-gram") and p["n"] == AMAZON_N}
    faster = min(sparse_sweep, key=sparse_sweep.get) if sparse_sweep else None
    for name, spec in families.items():
        PipelineEnv.get_or_create().reset()
        trace_dir = os.path.join(root, f"selector-amazon-{name}")
        t0 = time.perf_counter()
        with _CostFamily(spec), obs.tracing(trace_dir) as tracer:
            fitted = Sparsify().and_then(LeastSquaresEstimator(lam=AMAZON_LAM), train,
                                         labels).fit()
            records = list(tracer.events)
        run_s = time.perf_counter() - t0
        PipelineEnv.get_or_create().reset()
        # The selector's chain fits to Chained(Sparsify, model).
        (mapper,) = [getattr(op, "model", op) for op in
                     fitted.transformer_graph.operators.values()
                     if getattr(getattr(op, "model", op), "b_opt", None) is not None]
        W = _w1(mapper)
        del fitted, mapper
        (decision,) = _solver_decisions(records)
        args = decision["args"]
        outcome = args.get("outcome") or {}
        # A winner that phase 8 did not fit is held to its gather model.
        engine = CONTROL_AMAZON_ENGINES.get(args["winner"], "gather")
        want = refs["amazon"].get(engine)
        delta = float((W - want).abs().max()) if want is not None else None
        bound = CONTROL_AMAZON_W_TOL * refs["amazon_gather_scale"]
        out["amazon"][name] = dict(winner=args["winner"], measured_s=outcome.get("measured_s"),
                                   d=args["d"], sparsity=args["sparsity"],
                                   costs={c["label"]: c["cost_s"] for c in args["candidates"]},
                                   max_abs_delta_to_phase_8=delta,
                                   bits_of_phase_8=want is not None and torch.equal(W, want))
        out["dirs"][f"amazon-{name}"] = trace_dir
        log(f"  (c) Amazon {AMAZON_N} x {AMAZON_D} under {name}: winner {args['winner']}, "
            f"stamped {outcome.get('measured_s')} s (pipeline fit {run_s:.3f} s); the sweep "
            f"measured faster: {faster} ({sparse_sweep})")
        check(f"23(c) Amazon under {name}: the decision carries a stamped outcome",
              outcome.get("measured_s", 0) > 0, f"{outcome}")
        check(f"23(c) Amazon under {name}: the weights are phase 8's {engine} fit's",
              delta is not None and delta <= bound,
              f"max |delta| {delta} (tol {CONTROL_AMAZON_W_TOL} of phase 8's largest gather "
              f"weight, {bound:.3e}); bit for bit {out['amazon'][name]['bits_of_phase_8']}")
        del W
    del train, labels
    # The mis-route table over the sweep and the selector's traces, every
    # row re-priced under the refit (the traces mix two families).
    records = obs.load_events(sweep["dir"])
    for d in out["dirs"].values():
        records += obs.load_events(d)
    report = calmod.calibration_report(
        records, weights=calmod.family_weights(families["calibrated"]))
    out["misroutes"] = report["misroutes"]
    for m in report["misroutes"]:
        log(f"  (c) mis-route: {m['winner']} measured {m['winner_measured_s']} s, "
            f"{m['faster_candidate']} {m['faster_estimate_s']} s ({m['evidence']}), "
            f"regret {m['regret_s']} s")
    cal_winner = out["amazon"]["calibrated"]["winner"]
    if faster is not None and cal_winner != faster and cal_winner in sparse_sweep:
        check("23(c) the calibrated Amazon winner is the slower engine: the mis-route table "
              "names it", any(m["winner"] == cal_winner for m in report["misroutes"]),
              f"{cal_winner} against {faster}")
    # One streamed fit from disk shards: the span window against the stamp.
    PipelineEnv.get_or_create().reset()
    t0 = time.perf_counter()
    writer = DiskDenseShardWriter(os.path.join(root, "stream"), capacity_rows=CONTROL_STREAM_N,
                                  d_in=D_IN, k=K, tile_rows=DISK_TILE, tiles_per_segment=DISK_TPS)
    for X, Y, _ in disk_row_blocks(CONTROL_STREAM_N, 5, device):
        writer.append(X.cpu().numpy(), Y.cpu().numpy())
    sld = writer.close().as_labeled_data()
    log(f"  (c) {CONTROL_STREAM_N} rows written to shards in {time.perf_counter() - t0:.3f} s")
    trace_dir = os.path.join(root, "selector-stream")
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK, num_epochs=EPOCHS,
                         lam=DISK_LAM)
    auto = LeastSquaresEstimator(lam=DISK_LAM, block_size=BLOCK, block_iters=EPOCHS,
                                 host_budget_bytes=CONTROL_HOST_BUDGET)
    with _CostFamily("ec2"), obs.tracing(trace_dir) as tracer:
        timit.build_featurizer(config, device).and_then(auto, sld.data, sld.labels).fit()
        records = list(tracer.events)
    PipelineEnv.get_or_create().reset()
    (decision,) = _solver_decisions(records)
    stamped = (decision["args"].get("outcome") or {}).get("measured_s")
    unstamped = [dict(r, args={k: v for k, v in r["args"].items() if k != "outcome"})
                 if r is decision else r for r in records]
    (joined,) = calmod.join_decisions(
        [r for r in unstamped if r.get("name") != "estimator.fit"], kinds=("least_squares_solver",))
    folds = [r for r in records if r.get("type") == "span" and r["name"] == "fold.segment"]
    out["stream"] = dict(winner=decision["args"]["winner"], stamped_s=stamped,
                         span_window_s=joined.measured_s, timing=joined.timing,
                         fold_spans=len(folds))
    log(f"  (c) streamed disk fit ({CONTROL_STREAM_N} rows, {len(folds)} fold.segment spans): "
        f"stamped {stamped} s (synchronized) against the span window {joined.measured_s} s "
        f"({joined.timing})")
    check("23(c) the streamed fit: a stamped outcome and a span-window reading",
          decision["args"]["winner"] == "StreamingLeastSquaresChoice"
          and stamped is not None and stamped > 0 and joined.measured_s is not None
          and (joined.timing == calmod.QUEUED_TIMING) == (torch.device(device).type == "cuda"),
          f"{out['stream']}")
    out["dirs"]["stream"] = trace_dir
    checks = {k: v - checks_before.get(k, 0) for k, v in CONTROL_CHECK_LAUNCHES.items()
              if v - checks_before.get(k, 0)}
    out["launches"] = {k: v - checks.get(k, 0)
                       for k, v in _launch_delta(cuda_ops, before).items()
                       if v - checks.get(k, 0)}
    log(f"  (c) launches {out['launches']} (and {checks} holding kernels to their plain "
        "versions)")
    return out


class _Exporters:
    """Records every LiveExporter the CLI makes, to scrape it while it runs."""

    def __init__(self):
        from keystone_tpu_torch import obs

        self.obs = obs
        self.made = []
        self.cls = obs.LiveExporter
        made = self.made

        class Recording(self.cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        self.recording = Recording

    def __enter__(self):
        self.obs.LiveExporter = self.recording
        return self

    def __exit__(self, *exc):
        self.obs.LiveExporter = self.cls


def _serve_in_thread(argv):
    """``run.main(argv)`` on a thread, its stdout kept: (thread, result)."""
    import contextlib
    import io
    import threading

    from keystone_tpu_torch import run as cli

    result = {}

    def body():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result["rc"] = cli.main(argv)
        result["out"] = buf.getvalue()

    thread = threading.Thread(target=body, name="phase23-serve")
    thread.start()
    return thread, result


def phase_control_live(cuda_ops, blob, root, device="cuda"):
    """23(d): run.py serve on the TIMIT plan with the live exporter, scraped
    while it serves; then the same rate with the exporter off."""
    import urllib.request

    from keystone_tpu_torch.tools import slo as slo_cli
    from keystone_tpu_torch.workflow import PipelineEnv

    model = os.path.join(root, "timit.pkl")
    with open(model, "wb") as f:
        f.write(blob)
    base = ["serve", "--model", model, "--input-dim", str(D_IN), "--max-batch",
            str(CONTROL_SERVE_BATCH), "--rate", str(CONTROL_SERVE_RATE), "--duration-s",
            str(CONTROL_SERVE_S)] + ([] if torch.device(device).type == "cuda"
                                     else ["--device", "cpu"])
    metrics_dir, trace_dir = os.path.join(root, "metrics"), os.path.join(root, "serve-trace")
    out = {}
    before = dict(cuda_ops.launches)
    for name, extra in (("on", ["--metrics-port", "0", "--metrics-dir", metrics_dir,
                                "--metrics-interval-s", "0.25", f"--trace={trace_dir}"]),
                        ("off", [f"--trace={trace_dir}-off"])):
        PipelineEnv.get_or_create().reset()
        scraped = {}
        t0 = time.perf_counter()
        with _Exporters() as exporters:
            thread, result = _serve_in_thread(base + extra)
            deadline = time.time() + CONTROL_SERVE_S + 120
            while name == "on" and thread.is_alive() and time.time() < deadline:
                ex = exporters.made[0] if exporters.made else None
                if ex is not None and ex.metrics.snapshot().get("exporter.publishes", 0) >= 2:
                    url = f"http://127.0.0.1:{ex.port}"
                    for path in ("/metrics", "/healthz", "/snapshot.json"):
                        with urllib.request.urlopen(url + path, timeout=10) as resp:
                            scraped[path] = (resp.status, resp.read().decode())
                    break
                time.sleep(0.05)
            thread.join()
        run_s = time.perf_counter() - t0
        os.environ.pop("KEYSTONE_TRACE", None)
        PipelineEnv.get_or_create().reset()
        summary = json.loads(result["out"].strip().splitlines()[-1])
        out[name] = dict(rc=result["rc"], p50_ms=summary["p50_latency_ms"],
                         p99_ms=summary["p99_latency_ms"], qps=summary["achieved_qps"],
                         num_samples=summary["num_samples"], failed=summary["failed"])
        log(f"  (d) exporter {name}: rc {result['rc']}, p50 {summary['p50_latency_ms']} ms, "
            f"p99 {summary['p99_latency_ms']} ms, {summary['achieved_qps']} qps at "
            f"{CONTROL_SERVE_RATE} Hz offered, {summary['num_samples']} served, "
            f"{summary['failed']} failed; the command {run_s:.3f} s")
        check(f"23(d) serve with the exporter {name}: exit 0, books balance",
              result["rc"] == 0 and summary["num_offered"] == summary["num_samples"]
              + summary["rejected"] + summary["failed"], f"{summary}")
        if name == "on":
            with open(os.path.join(metrics_dir, "live_metrics.json")) as f:
                snap = json.load(f)
            publishes = snap["exporter"]["exporter.publishes"]
            metrics = scraped.get("/metrics", (None, ""))
            snap_live = json.loads(scraped["/snapshot.json"][1]) if "/snapshot.json" in \
                scraped else {}
            rc_slo, slo_out = _tool(slo_cli.main, [metrics_dir])
            out[name].update(publishes=publishes, metrics_port=summary.get("metrics_port"),
                             metrics_lines=len(metrics[1].splitlines()), slo_rc=rc_slo)
            log(f"  (d) scraped /metrics ({len(metrics[1].splitlines())} lines, status "
                f"{metrics[0]}), /healthz {scraped.get('/healthz')}, /snapshot.json seq "
                f"{snap_live.get('seq')}; {publishes} publishes; tools.slo rc {rc_slo}:")
            for line in slo_out.splitlines():
                log(f"      {line}")
            check("23(d) the live endpoint answered while serving, and published twice",
                  metrics[0] == 200 and "keystone_serving_completed" in metrics[1]
                  and scraped.get("/healthz") == (200, "ok\n") and publishes >= 2
                  and rc_slo == 0, f"{publishes} publishes, scraped {sorted(scraped)}")
    out["trace_dir"] = trace_dir
    out["model"] = model
    out["launches"] = _launch_delta(cuda_ops, before)
    log(f"  (d) launches {out['launches']}")
    return out


def phase_control_plan(cuda_ops, live, selector, root, device="cuda"):
    """23(e): tools.plan --apply on the serve trace joined with the
    selector's decisions priced on TIMIT's features (the gate replays
    them), and refused on the serve trace joined with a fitted selector
    trace whose stamped outcome drifts past the bound; serve --from-plan,
    tools.trace and its decision view; the selector traces replayed."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.placement.planner import CapacityPlanner
    from keystone_tpu_torch.tools import plan as plan_cli
    from keystone_tpu_torch.tools import trace as trace_cli
    from keystone_tpu_torch.workflow import PipelineEnv

    plan_path = os.path.join(root, "plan.json")
    priced = selector["chunks"]["decisions_dir"]
    rc, text = _tool(plan_cli.main, [live["trace_dir"], priced, "--apply", plan_path,
                                     "--whatif", "traffic=2x", "--whatif", "hbm=0.5x"])
    for line in text.splitlines():
        log(f"      {line}")
    fidelity = {}
    if os.path.exists(plan_path):
        with open(plan_path) as f:
            fidelity = json.load(f)["fidelity"]
    check("23(e) tools.plan --apply: the 1x fidelity gate replays the priced decisions, "
          "passes, and the artifact is written",
          rc == 0 and fidelity.get("num_replayed", 0) > 0
          and fidelity["num_reproduced"] == fidelity["num_replayed"], f"rc {rc}, {fidelity}")
    refused_path = os.path.join(root, "plan-refused.json")
    drifted = selector["dirs"]["amazon-ec2"]
    rc_refused, _ = _tool(plan_cli.main, [live["trace_dir"], drifted, "--apply",
                                          refused_path])
    check("23(e) tools.plan --apply refuses a trace whose stamped outcome drifts (the Amazon "
          "fit priced under ec2)", rc_refused == 2 and not os.path.exists(refused_path),
          f"rc {rc_refused}, artifact written {os.path.exists(refused_path)}")
    before = dict(cuda_ops.launches)
    PipelineEnv.get_or_create().reset()
    argv = ["serve", "--model", live["model"], "--input-dim", str(D_IN), "--duration-s", "1.0",
            "--rate", str(CONTROL_SERVE_RATE), "--from-plan", plan_path] + (
        [] if torch.device(device).type == "cuda" else ["--device", "cpu"])
    from keystone_tpu_torch import run as cli

    rc_serve, serve_out = _tool(cli.main, argv)
    PipelineEnv.get_or_create().reset()
    summary = json.loads(serve_out.strip().splitlines()[-1])
    stamp = summary.get("plan_artifact") or {}
    log(f"  (e) serve --from-plan: rc {rc_serve}, applied {stamp.get('applied')}, p99 "
        f"{summary['p99_latency_ms']} ms")
    check("23(e) serve --from-plan runs and stamps the artifact's provenance",
          rc_serve == 0 and stamp.get("path") == plan_path and stamp.get("source_traces"),
          f"{stamp}")
    rc_t, t_out = _tool(trace_cli.main, [live["trace_dir"]])
    rc_d, d_out = _tool(trace_cli.main, [selector["dirs"]["timit-ec2"], "--decisions"])
    for line in (t_out.splitlines()[:8] + d_out.splitlines()):
        log(f"      {line}")
    check("23(e) tools.trace and tools.trace --decisions render", rc_t == 0 and rc_d == 0,
          f"rc {rc_t}, {rc_d}")
    replays = {}
    for name, d in selector["dirs"].items():
        fid = CapacityPlanner(obs.load_events(d)).fidelity()
        replays[name] = (fid["num_reproduced"], fid["num_replayed"], fid["max_abs_log_error"])
    log(f"  (e) selector traces replayed at 1x (reproduced, replayed, worst |log error|): "
        f"{replays}")
    check("23(e) every recorded selector decision replays to its winner",
          all(r[0] == r[1] > 0 for r in replays.values()), f"{replays}")
    return dict(plan_rc=rc, fidelity=fidelity, refused_rc=rc_refused, serve_summary=summary,
                replays=replays, launches=_launch_delta(cuda_ops, before))


FLEET = ("process fleet: TIMIT's plan shipped to plane processes, a SIGKILL under load, run.py "
         "serve --fleet, the chaos tool, quarantine and a canary")
# 24(a)/(b): TIMIT's full-width plan (phase 19's seed-0 fit, max_batch 256)
# on 2 planes of 1 replica; a 200 Hz storm of 3 s with plane0 SIGKILLed
# halfway.
FLEET_PLANES, FLEET_STORM_HZ, FLEET_STORM_S = 2, 200.0, 3.0
# 24(c): run.py serve --fleet 2 at MnistRandomFFT's defaults.
FLEET_CLI_RATE, FLEET_CLI_S = 200.0, 2.0
# 24(b): the card's free memory after the respawn against before the kill.
FLEET_MEM_TOL = 0.05


def _free_bytes(device):
    """The card's free memory (``cudaMemGetInfo``, every process's use
    counted), 0 on the CPU."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def _tensor_devices(obj):
    """The device types of every tensor ``obj`` pickles."""
    import io

    found = set()

    class Walk(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor):
                found.add(o.device.type)
            return NotImplemented

    Walk(io.BytesIO(), protocol=4).dump(obj)
    return found


def _fleet_router(ship, device, num_planes=FLEET_PLANES):
    from keystone_tpu_torch.serving.fleet import FleetRouter

    return FleetRouter(ship, num_planes=num_planes, replicas_per_plane=1,
                       heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0, restart_budget=2,
                       spawn_retry_delay_s=0.05, startup_timeout_s=180.0,
                       plane_cfg={"device": str(device), "max_wait_ms": 2.0})


def phase_fleet_serve(blob, pool, device="cuda"):
    """24(a): TIMIT's plan shipped to two plane processes; every bucket's
    rows served through the fleet against the parent's batch apply. Returns
    the live fleet (the caller closes it), the ship and the readings."""
    from keystone_tpu_torch.serving import export_plan
    from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

    cuda = torch.device(device).type == "cuda"
    fitted = pickle.loads(blob)
    plan = export_plan(fitted, np.zeros(D_IN, np.float32), max_batch=SERVE_MAX_BATCH,
                       device=device)
    t0 = time.perf_counter()
    ship = encode_plan_ship(fitted, plan)
    encode_s = time.perf_counter() - t0
    skeleton = _tensor_devices(pickle.loads(ship.skeleton))  # where plain unpickling puts them
    check("24(a) the ship's skeleton pickles every tensor from the host",
          skeleton == {"cpu"}, f"skeleton tensors on {skeleton}, {len(ship.skeleton)} bytes, "
          f"{len(ship.tensors)} split-plane tensors, encoded in {encode_s:.3f} s")
    free0 = _free_bytes(device)
    fleet = _fleet_router(ship, device)
    try:
        boot = fleet.boot_seconds()
        pids = fleet.plane_pids()
        footprint = (free0 - _free_bytes(device)) / FLEET_PLANES
        bits = {}
        for b in plan.buckets:
            rows = pool[:b]
            want = plan.apply_batch(list(rows))
            futures = [fleet.submit(r) for r in rows]
            served = np.stack([f.result(timeout=120) for f in futures])
            bits[b] = served.tobytes() == np.ascontiguousarray(want).tobytes()
        replies = fleet.plane_stats()
        # Each plane's own process's counters, from its spawn.
        launches = {n: {k: v for k, v in r["launches"].items() if v}
                    for n, r in replies.items() if r}
        stats = fleet.stats()
        _fleet_serve_checks(cuda, boot, pids, footprint, bits, replies, launches, stats)
    except BaseException:
        fleet.close()
        raise
    fleet_launches = {k: sum(l.get(k, 0) for l in launches.values())
                      for k in ("cosine_features", ROW_STABLE)}
    return fleet, ship, dict(boot_s=boot, boot_stages={n: r["boot"] for n, r in replies.items()
                                                        if r},
                             card_mib_a_plane=footprint / 2**20, bits=bits, launches=launches,
                             fleet_launches=fleet_launches, footprint=footprint)


def _fleet_serve_checks(cuda, boot, pids, footprint, bits, replies, launches, stats):
    log(f"  (a) {FLEET_PLANES} planes booted in {boot} s (spawn to bootstrap reply), pids "
        f"{pids}; card memory {footprint / 2**20:.1f} MiB a plane (free before and after "
        f"boot); a plane's allocator "
        f"{ {n: r['device_memory'] for n, r in replies.items() if r} }; boot stages (s) "
        f"{ {n: {k: round(v, 3) for k, v in r['boot'].items()} for n, r in replies.items() if r} }")
    log(f"  (a) bit-equal rows by bucket {bits}; served by plane "
        f"{ {n: p['completed'] for n, p in stats['planes'].items()} }; plane launches {launches}")
    check("24(a) rows served through the fleet equal the parent's plan batch apply bit for bit, "
          "every bucket", all(bits.values()), f"{bits}")
    check("24(a) both planes served and quarantined nothing",
          stats["healthy_planes"] == FLEET_PLANES and stats["quarantined_planes"] == []
          and all(p["completed"] > 0 for p in stats["planes"].values()),
          f"{stats['planes']}")
    check("24(a) each plane launched cosine_features and row_stable_matmul" if cuda else
          "24(a) plane launch counters read",
          all(l.get("cosine_features", 0) > 0 and l.get(ROW_STABLE, 0) > 0
              for l in launches.values()) if cuda else len(launches) == FLEET_PLANES,
          f"{launches}")


def phase_fleet_kill(fleet, pool, footprint, device="cuda"):
    """24(b): plane0 SIGKILLed halfway through a 200 Hz open-loop storm."""
    import signal
    import threading

    from keystone_tpu_torch.serving import run_open_loop

    cuda = torch.device(device).type == "cuda"
    free_before = _free_bytes(device)
    victim = fleet.plane_pids()["plane0"]
    books = ("aggregate_offered", "completed", "rejected", "failed")
    s0 = fleet.stats()
    futures = []
    killed = {}

    def submit(x, deadline_ms=None):
        fut = fleet.submit(x, deadline_ms)
        futures.append(fut)
        return fut

    def kill():
        killed["t"] = time.perf_counter()
        os.kill(victim, signal.SIGKILL)

    timer = threading.Timer(FLEET_STORM_S / 2, kill)
    timer.start()
    try:
        report = run_open_loop(submit, lambda i: pool[i % len(pool)], rate_hz=FLEET_STORM_HZ,
                               duration_s=FLEET_STORM_S, seed=24)
    finally:
        timer.cancel()
        timer.join()
    deadline = time.monotonic() + 180.0
    respawn_s = None
    while time.monotonic() < deadline:
        s = fleet.stats()
        if s["restarts_total"] >= 1 and s["healthy_planes"] == FLEET_PLANES:
            respawn_s = time.perf_counter() - killed["t"]
            break
        time.sleep(0.05)
    while not fleet.accounting_ok() and time.monotonic() < deadline:
        time.sleep(0.05)
    free_after = _free_bytes(device)
    s = fleet.stats()
    reborn = (fleet.plane_stats().get("plane0") or {}).get("boot")
    storm = {k: s[k] - s0[k] for k in books}  # the storm's share of the router's books
    names = [type(f.exception(timeout=60)).__name__ for f in futures
             if f.exception(timeout=60) is not None]
    log(f"  (b) {report.num_offered} offered at {FLEET_STORM_HZ:.0f} Hz for {FLEET_STORM_S} s, "
        f"plane0 (pid {victim}) killed at {FLEET_STORM_S / 2} s: the router's books for the "
        f"storm {storm} ({ {n: names.count(n) for n in set(names)} }); respawned as pid "
        f"{fleet.plane_pids()['plane0']} {respawn_s} s after the kill (boot "
        f"{fleet.boot_seconds()['plane0']} s, by stage {reborn}); merged p50 "
        f"{s['fleet_p50_latency_s']} s, p99 {s['fleet_p99_latency_s']} s over "
        f"{s['fleet_latency_count']}; loadgen p99 "
        f"{report.p99_latency_s}; free memory {free_before} before the kill, {free_after} after "
        f"the respawn")
    check("24(b) the books balance exactly across the kill, on the router's side and the "
          "loadgen's",
          fleet.accounting_ok() and storm["aggregate_offered"] == report.num_offered
          == report.completed + report.rejected + report.failed
          and storm["aggregate_offered"] == storm["completed"] + storm["rejected"]
          + storm["failed"] and storm["failed"] == report.failed,
          f"router {storm}, inflight {s['inflight']}; loadgen offered {report.num_offered}, "
          f"completed {report.completed}, rejected {report.rejected}, failed {report.failed}")
    check("24(b) every failure is the dead plane's FleetPlaneDied",
          storm["failed"] == names.count("FleetPlaneDied")
          and set(names) <= {"FleetPlaneDied", "FleetSaturated"},
          f"failed {storm['failed']}, future errors { {n: names.count(n) for n in set(names)} }")
    check("24(b) plane0 respawned with a new pid inside its budget",
          respawn_s is not None and s["restarts_total"] == 1 and s["evicted_planes"] == []
          and fleet.plane_pids()["plane0"] not in (None, victim),
          f"restarts {s['restarts_total']}, evicted {s['evicted_planes']}, pids "
          f"{fleet.plane_pids()} (victim {victim})")
    gap = free_before - free_after
    check("24(b) the card's free memory returns after the respawn (within 5% of before the "
          "kill, and less than half a plane's footprint gone)" if cuda else
          "24(b) memory readings taken",
          (abs(gap) <= FLEET_MEM_TOL * free_before and gap < footprint / 2) if cuda else True,
          f"free {free_before} -> {free_after} bytes (gap {gap}, a plane {footprint:.0f})")
    return dict(storm=storm, respawn_s=respawn_s,
                respawn_boot_s=fleet.boot_seconds()["plane0"], respawn_boot_stages=reborn,
                p50_s=s["fleet_p50_latency_s"], p99_s=s["fleet_p99_latency_s"],
                free_before=free_before, free_after=free_after)


def phase_fleet_cli(cuda_ops, device="cuda"):
    """24(c): run.py serve --fleet 2 at MnistRandomFFT's defaults, with this
    process's full (generation 2) garbage collections logged: serve runs
    its storm with the heap frozen (C.14), and its first collection is the
    one that freezes it. (The in-process --replicas 2 reading beside it
    went in PR 26: phase 19(b) runs that mode, and
    scripts/torch_fleet_tail.py compares the two tails.)"""
    import contextlib
    import gc
    import io

    from keystone_tpu_torch import run as cli
    from keystone_tpu_torch.workflow import PipelineEnv

    cuda = torch.device(device).type == "cuda"
    PipelineEnv.get_or_create().reset()
    argv = ["serve", "--rate", str(FLEET_CLI_RATE), "--duration-s", str(FLEET_CLI_S),
            "--fleet", "2"] + ([] if cuda else ["--device", "cpu"])
    buf = io.StringIO()
    full, started = [], []  # (start s into the run, pause s); a start's time

    def on_gc(stage, info):
        if info["generation"] == 2 and stage == "start":
            started.append(time.perf_counter())
        elif info["generation"] == 2 and started:
            t = started.pop()
            full.append((round(t - t0, 3), round(time.perf_counter() - t, 4)))

    t0 = time.perf_counter()
    gc.callbacks.append(on_gc)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        gc.callbacks.remove(on_gc)
    seconds = time.perf_counter() - t0
    PipelineEnv.get_or_create().reset()
    fleet = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  (c) serve --fleet 2: {json.dumps(fleet)}")
    log(f"  (c) full collections (s into the run, pause s): {full}")
    log(f"  (c) at {FLEET_CLI_RATE:.0f} Hz: --fleet 2 p50 {fleet['p50_latency_ms']} ms, p99 "
        f"{fleet['p99_latency_ms']} ms ({seconds:.1f} s with the fit and the planes' boot)")
    check("24(c) serve --fleet 2: exit 0, the fleet's books balance, none failed",
          rc == 0 and fleet["fleet_accounting_ok"] is True
          and fleet["fleet_failed"] == 0 and fleet["num_planes"] == 2
          and fleet["healthy_planes"] == 2,
          f"rc {rc}, offered {fleet['aggregate_offered']}, completed "
          f"{fleet['fleet_completed']}, rejected {fleet['fleet_rejected']}, failed "
          f"{fleet['fleet_failed']}")
    return dict(fleet=dict(p50_ms=fleet["p50_latency_ms"], p99_ms=fleet["p99_latency_ms"],
                           seconds=seconds, full_gc=full))


def phase_fleet_chaos(fleet, pool, device="cuda"):
    """24(d): ``tools.fleet_chaos``'s drill (``fleet_chaos.drill``: a
    4-tenant open-loop storm, the first plane SIGKILLed halfway, the
    respawn, the books) on (a)'s fleet, which (e) has rolled to the seed-1
    plan: the tool's own run fits and boots a fleet of its own
    (tests/test_torch_storm_heap.py runs it whole on the CPU)."""
    from keystone_tpu_torch.tools import fleet_chaos

    rates = {f"t{i}": FLEET_STORM_HZ / 4 for i in range(4)}
    t0 = time.perf_counter()
    verdict = fleet_chaos.drill(fleet, pool, rates, duration_s=FLEET_STORM_S, seed=25,
                                respawn_timeout_s=180.0)
    seconds = time.perf_counter() - t0
    keys = ("books_balance", "respawn_fired", "loadgen_books_balance", "offered", "completed",
            "rejected", "failed", "victim_pid", "respawned_pid", "restarts_total",
            "fleet_p99_latency_s")
    log(f"  (d) fleet_chaos.drill on (a)'s fleet in {seconds:.1f} s: "
        f"{ {k: verdict[k] for k in keys} }")
    check("24(d) the chaos drill on (a)'s fleet: books balance, the killed plane respawned",
          fleet_chaos.verdict_ok(verdict),
          f"books_balance {verdict['books_balance']}, respawn_fired {verdict['respawn_fired']}, "
          f"loadgen books {verdict['loadgen_books_balance']}, pids {verdict['victim_pid']} -> "
          f"{verdict['respawned_pid']}")
    return {k: verdict[k] for k in keys} | dict(seconds=seconds)


def phase_fleet_integrity(fleet, blob, ship, pool, device="cuda"):
    """24(e): a canary (the seed-1 TIMIT fit) rolled across both planes of
    ``fleet``; then a ship corrupted through a ``fleet.rpc.send`` corrupt
    rule quarantines the plane it boots."""
    from keystone_tpu_torch.serving import export_plan
    from keystone_tpu_torch.serving.fleet import FleetPlaneDied
    from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

    fitted2 = pickle.loads(blob)
    plan2 = export_plan(fitted2, np.zeros(D_IN, np.float32), max_batch=SERVE_MAX_BATCH,
                        device=device)
    t0 = time.perf_counter()
    results = fleet.offer_canary(encode_plan_ship(fitted2, plan2), timeout_s=300.0)
    canary_s = time.perf_counter() - t0
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and any(
            p["fingerprint"] != plan2.fingerprint for p in fleet.stats()["planes"].values()):
        time.sleep(0.05)
    fps = {n: p["fingerprint"] for n, p in fleet.stats()["planes"].items()}
    rows = pool[:16]
    served = np.stack([f.result(timeout=120) for f in [fleet.submit(r) for r in rows]])
    bits = served.tobytes() == np.ascontiguousarray(plan2.apply_batch(list(rows))).tobytes()
    outcome = {n: r.get("result", r) for n, r in results.items()}
    log(f"  (e) canary in {canary_s:.1f} s: {outcome}; planes' fingerprints {fps}; rows after "
        f"the roll bit-equal to the seed-1 plan: {bits}")
    check("24(e) offer_canary publishes the seed-1 plan on both planes and switches their "
          "fingerprints",
          all(r.get("ok") and r["result"]["published"]
              and r["result"]["fingerprint"] == plan2.fingerprint for r in results.values())
          and set(fps.values()) == {plan2.fingerprint} and bits,
          f"{results}, fingerprints {fps}, bits {bits}")
    spec = json.dumps({"rules": [{"site": "fleet.rpc.send", "kind": "corrupt", "p": 1.0}],
                       "seed": 0})
    os.environ["KEYSTONE_FAULT_PLAN"] = spec
    try:
        qfleet = _fleet_router(ship, device, num_planes=1)
    finally:
        os.environ.pop("KEYSTONE_FAULT_PLAN", None)
    try:
        s = qfleet.stats()
        reply = qfleet.plane_stats()["plane0"]
        try:
            qfleet.submit(pool[0]).result(timeout=60)
            refused = None
        except FleetPlaneDied as e:
            refused = str(e)
        s = qfleet.stats()
    finally:
        qfleet.close()
    log(f"  (e) corrupted ship: quarantined {s['quarantined_planes']}, the plane says "
        f"{reply and reply['quarantined']!r}; a request refused: {refused!r}")
    check("24(e) a ship corrupted in transit quarantines its plane, which refuses by name and "
          "serves nothing",
          s["quarantined_planes"] == ["plane0"] and s["healthy_planes"] == 0
          and reply is not None and "CRC" in (reply["quarantined"] or "")
          and refused is not None and "quarantined" in refused
          and s["completed"] == 0 and s["failed"] == 1 and qfleet.accounting_ok(),
          f"{s['quarantined_planes']}, completed {s['completed']}, failed {s['failed']}, "
          f"refused {refused!r}")
    return dict(canary_s=canary_s, fingerprints=fps, quarantine=reply and reply["quarantined"])


MESH = ("one-host mesh: 8 shards on one card, TIMIT --solver block on sharded rows, the "
        "streamed and block-streamed mesh folds, tools.multichip")
MESH_SHARDS = 8
# 25(b): the streamed mesh fold on 131,072 rows, 16,384 a shard: one tile a
# shard (the tile of phase 4, 32,768 rows, cut to the shard), four tiles on
# one device.
MESH_STREAM_N = 131072
# 25(c): the block-streamed tier's mesh form on 32,768 rows, the last 100
# padding (the last shard holds 3,996 valid rows of 4,096).
MESH_BLOCK_N, MESH_BLOCK_PAD = 32768, 100
# 25(d): tools.multichip at the reference's chip leg (tests/test_multichip.py
# TestMultichipOnChips): n = 2,000,000 padded-COO rows of 64 lanes, d =
# 4,096, 31 chunks of 65,536 rows (4 a shard, the last shard's 3), where
# the EC2 prices pick 8 x 1 (at n = 500,000 the one psum of the 4,096²
# Gramian outprices the fold, and 1 x 1 wins).
MESH_MC_ARGV = ["--n", "2000000", "--d", "4096", "--nnz", "64", "--chunk", "65536",
                "--seg", "4", "--iters", "30"]
# The CPU tests' tolerances (tests/test_torch_mesh_solvers.py): the mesh
# BCD's weights and the folded statistics 1e-5 relative Frobenius of the
# one-device form's (the psum reassociates the shards' sums); the streamed
# fits' models 1e-4 (held on predictions: see phase_mesh_streamed).
MESH_BCD_TOL, MESH_STREAM_TOL = 1e-5, 1e-4


def _mesh(device):
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh((MESH_SHARDS,), devices=[device] * MESH_SHARDS)


def _hold(cuda_ops, label, got_fn, want, scale, tol, mask=None):
    """One kernel call at a mesh shard's shape against its plain version:
    the largest error relative to the sums' scale (over ``mask``)."""
    got = got_fn()
    if isinstance(got, tuple):
        got = torch.cat([g.reshape(-1) for g in got])
        want = torch.cat([w.reshape(-1) for w in want])
        scale = torch.cat([c.reshape(-1) for c in scale])
    diff = (got.float() - want.float()).abs()
    if mask is not None:
        diff, scale = diff[mask], scale[mask]
    err = diff.max().item()
    rel = (diff / scale).max().item()
    check(f"25 {label}", rel <= tol, f"max_abs_err {err:.3e} ({rel:.2e} of scale, tol {tol:.0e})")
    return err


def phase_mesh_shapes(cuda_ops, device="cuda"):
    """25: each kernel of the mesh path against its plain version at the
    shard shapes phase 25 gives it (launches not counted as the path's):
    a cosine branch and a centred block of 25(a)'s 8,192-row shard, a
    16,384-row tile of 25(b), a 4,096-row block slab of 25(c), a 65,536-row
    chunk of 25(d). Tolerances of phase 1: the cosine 1e-5 absolute, the
    sums 1e-4 of their scale (|terms| summed)."""
    gen = torch.Generator(device=device).manual_seed(25)
    errs = {}
    rows = N_TRAIN // MESH_SHARDS
    X = torch.randn((rows, D_IN), generator=gen, device=device) * 0.6
    W = torch.randn((BLOCK, D_IN), generator=gen, device=device) * 0.05555
    b = torch.rand((BLOCK,), generator=gen, device=device) * 6.283185307179586
    errs["cosine_features"] = _hold(
        cuda_ops, f"cosine_features X {rows}x{D_IN} @ {BLOCK}x{D_IN} (a 25(a) shard)",
        lambda: cuda_ops.cosine_features(X, W, b), cuda_ops.cosine_features_ref(X, W, b),
        torch.ones(rows, BLOCK, device=device), 1e-5)
    A = cuda_ops.cosine_features(X, W, b)
    A -= A.mean(dim=0)
    R = torch.randn((rows, K), generator=gen, device=device)
    scale = (A.abs().T @ A.abs(), A.abs().T @ R.abs())
    errs["gram_corr_sym"] = _hold(
        cuda_ops, f"gram_corr_sym A {rows}x{BLOCK}, R {rows}x{K} (a 25(a) shard)",
        lambda: cuda_ops.gram_corr_sym(A, R), cuda_ops.gram_corr_sym_ref(A, R), scale, 1e-4)
    del X, W, b, A, R, scale
    tile = MESH_STREAM_N // MESH_SHARDS
    F = torch.randn((tile, D_FEAT), generator=gen, device=device)
    G0 = torch.randn((D_FEAT, D_FEAT), generator=gen, device=device)
    tiles = torch.arange(D_FEAT, device=device) // 128
    upper = tiles[:, None] <= tiles[None, :]
    errs["gram_sym_acc"] = _hold(
        cuda_ops, f"gram_sym_acc F {tile}x{D_FEAT} (a 25(b) shard's tile), upper tiles",
        lambda: cuda_ops.gram_sym_acc(G0, F), cuda_ops.gram_sym_acc_ref(G0, F),
        torch.addmm(G0.abs(), F.abs().T, F.abs()), 1e-4, mask=upper)
    del F, G0, tiles, upper
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    rows = MESH_BLOCK_N // MESH_SHARDS
    F = torch.randn((rows, BLOCK), generator=gen, device=device)
    R = torch.randn((rows, K), generator=gen, device=device)
    dW = torch.randn((BLOCK, K), generator=gen, device=device) * 1e-2
    errs["block_corr"] = _hold(
        cuda_ops, f"block_corr F {rows}x{BLOCK}, R {rows}x{K} (a 25(c) shard's slab)",
        lambda: cuda_ops.block_corr(F, 0, BLOCK, R), cuda_ops.block_corr_ref(F, 0, BLOCK, R),
        F.abs().T @ R.abs(), 1e-4)
    errs["block_residual_update"] = _hold(
        cuda_ops, f"block_residual_update F {rows}x{BLOCK}, dW {BLOCK}x{K} (a 25(c) shard)",
        lambda: cuda_ops.block_residual_update(F, 0, BLOCK, dW, R),
        cuda_ops.block_residual_update_ref(F, 0, BLOCK, dW, R),
        R.abs() + F.abs() @ dW.abs(), 1e-4)
    del F, R, dW
    chunk, d = int(MESH_MC_ARGV[7]), int(MESH_MC_ARGV[3])
    F = torch.randn((chunk, d), generator=gen, device=device)
    Yc = torch.randn((chunk, 2), generator=gen, device=device)
    G0 = torch.zeros((d, d), device=device)
    C0 = torch.zeros((d, 2), device=device)
    tiles = torch.arange(d, device=device) // 128
    upper = torch.cat([(tiles[:, None] <= tiles[None, :]).reshape(-1),
                       torch.ones(d * 2, dtype=torch.bool, device=device)])
    errs["gram_corr_sym_acc"] = _hold(
        cuda_ops, f"gram_corr_sym_acc F {chunk}x{d}, R {chunk}x2 (a 25(d) chunk), upper tiles",
        lambda: cuda_ops.gram_corr_sym_acc(G0, C0, F, Yc),
        cuda_ops.gram_corr_sym_acc_ref(G0, C0, F, Yc),
        (F.abs().T @ F.abs(), F.abs().T @ Yc.abs()), 1e-4, mask=upper)
    del F, Yc, G0, C0
    return errs


def _launches_since(cuda_ops):
    return {k: v for k, v in cuda_ops.launches.items() if v}


def phase_mesh_timit(cuda_ops, timit, TimitConfig, stacked, smi, device="cuda"):
    """25(a): TIMIT --solver block (timit.run's pipeline: the featurizer,
    BlockLeastSquares, MaxClassifier) on phase 2's rows and draws, sharded
    over 8 shards: the fit falls back from the fused flat fit, as the
    reference's does on a mesh; each shard's cosine branches, then the
    mesh BCD (each shard's gram_corr_sym in epoch 1, one psum a block
    step). Weights and affine offset held against phase 2's apply-first
    (stacked) fit, the one-device fit of the same iterates."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import PipelineEnv

    mesh = _mesh(device)
    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="block", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=N_TRAIN, num_epochs=EPOCHS)
    train = synthetic_timit(N_TRAIN, seed=config.seed, device=device)
    test = synthetic_timit(N_TRAIN // 4, seed=config.seed + 1, device=device)
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    data, sharded_labels = train.data.shard(mesh), labels.shard(mesh)
    pipeline = timit.build_featurizer(config, device).and_then(
        BlockLeastSquaresEstimator(BLOCK, EPOCHS, config.lam), data, sharded_labels,
    ).and_then(MaxClassifier())
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    _sync(device)
    fit_s = time.perf_counter() - t0
    fit_counts = _launches_since(cuda_ops)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_pred = fitted.apply(data)
    test_pred = fitted.apply(test.data.shard(mesh))
    _sync(device)
    apply_s = time.perf_counter() - t0
    apply_counts = _launches_since(cuda_ops)
    PipelineEnv.get_or_create().reset()
    evaluator = MulticlassClassifierEvaluator(K)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    W, offset = block_model(fitted)
    rel_W, rel_off = _rel(W, stacked[0]), _rel(offset, stacked[1])
    log(f"  (a) {MESH_SHARDS} shards of {N_TRAIN // MESH_SHARDS} rows, d={D_FEAT}, k={K}, block "
        f"{BLOCK}, {EPOCHS} epochs: fit {fit_s:.3f} s, apply (train + test) {apply_s:.3f} s, "
        f"train error {100 * train_eval.total_error:.3f}%, test error "
        f"{100 * test_eval.total_error:.3f}%; weights {rel_W:.3e}, offset {rel_off:.3e} "
        f"relative to phase 2's one-device fit; launches fit {fit_counts}, apply "
        f"{apply_counts} ({smi})")
    want = {"cosine_features": NUM_COSINES * MESH_SHARDS,
            "gram_corr_sym": NUM_COSINES * MESH_SHARDS}
    check("25(a) the fit's launches: each shard's cosine branches and its gram_corr_sym a "
          "block in epoch 1, nothing of the fused flat fit",
          same_launches(fit_counts, want), f"{fit_counts}, expected {want}")
    check("25(a) the mesh fit's weights and offset match the one-device fit's",
          rel_W <= MESH_BCD_TOL and rel_off <= MESH_BCD_TOL,
          f"weights {rel_W:.2e}, affine offset {rel_off:.2e} relative Frobenius "
          f"(tol {MESH_BCD_TOL:.0e})")
    check_metrics("25(a)", train_eval, test_eval, N_TRAIN)
    del fitted, train, test, data, sharded_labels, labels, train_pred, test_pred
    return dict(fit_seconds=fit_s, apply_seconds=apply_s, fit_launches=fit_counts,
                apply_launches=apply_counts, weights_rel=rel_W, offset_rel=rel_off,
                train_error=train_eval.total_error, test_error=test_eval.total_error)


def _timit_rows(n, seed, device):
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels

    rows = synthetic_timit(n, seed=seed, device=device)
    Y = ClassLabelIndicatorsFromIntLabels(K)(rows.labels).array
    return rows.data.array, Y


def _centred_predictions(cuda_ops, X, W, fmean, ymean, Wrf, brf):
    """A centred streamed model's predictions (F − fmean) W + ymean on the
    rows X, F = cos(X Wrfᵀ + brf)."""
    F = cuda_ops.cosine_features(X.contiguous(), Wrf, brf)
    return (F - fmean) @ W.reshape(F.shape[1], -1) + ymean


# 25(b)/(c): rows of the training set whose predictions the mesh and the
# one-device models are compared on.
MESH_PRED_ROWS = 16384


def phase_mesh_streamed(cuda_ops, timit, TimitConfig, smi, device="cuda"):
    """25(b): streaming_bcd_fit_mesh_centered on phase 4's cosine bank
    (each shard's tile through the bank and gram_sym_acc, one psum of the
    stats) against streaming_bcd_fit_centered on the same rows. Held: the
    folded statistics (gram_stats_mesh against gram_stats, 1e-5 relative:
    the psum reassociates the shards' sums) and the fitted models'
    predictions on the first rows (1e-4 relative). The weights are a
    reading: at λ = 0 the centred normal equations amplify the sums'
    rounding (call 1: 4.5e-4 between the mesh and one-device weights),
    as the one-device fit's own retiling shows beside them."""
    from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize
    from keystone_tpu_torch.parallel import mesh as mesh_lib
    from keystone_tpu_torch.parallel import streaming

    mesh = _mesh(device)
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK)
    rfs = timit._cosine_models(config, device)
    Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
    bank = CosineBankFeaturize(Wrf, brf)
    del rfs
    X, Y = _timit_rows(MESH_STREAM_N, 4, device)
    kw = dict(featurize=bank, d_feat=D_FEAT, tile_rows=STREAM_TILE, block_size=BLOCK, lam=0.0,
              num_iter=EPOCHS)
    Xs, Ys = mesh_lib.shard_rows(X, mesh), mesh_lib.shard_rows(Y, mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = streaming.streaming_bcd_fit_mesh_centered(Xs, Ys, mesh=mesh, n_true=MESH_STREAM_N, **kw)
    _sync(device)
    mesh_s = time.perf_counter() - t0
    counts = _launches_since(cuda_ops)
    t0 = time.perf_counter()
    want = streaming.streaming_bcd_fit_centered(X, Y, **kw)[:3]
    _sync(device)
    one_s = time.perf_counter() - t0
    shard_rows = MESH_STREAM_N // MESH_SHARDS
    retiled = streaming.streaming_bcd_fit_centered(X, Y, **(kw | dict(tile_rows=shard_rows)))[0]
    stats = streaming.gram_stats_mesh(Xs, Ys, bank, D_FEAT, STREAM_TILE, mesh, moments=True)
    stats_rels = [_rel(g.reshape(-1), w.reshape(-1)) for g, w in zip(
        stats, streaming.gram_stats(X, Y, bank, D_FEAT, STREAM_TILE, moments=True))]
    del stats
    rows = X[:MESH_PRED_ROWS]
    pred_rel = _rel(_centred_predictions(cuda_ops, rows, got[0], got[1], got[2], Wrf, brf),
                    _centred_predictions(cuda_ops, rows, want[0], want[1], want[2], Wrf, brf))
    rels = [_rel(g, w) for g, w in zip(got, want)]
    retile_rel = _rel(retiled, want[0])
    log(f"  (b) n={MESH_STREAM_N} on {MESH_SHARDS} shards: mesh fit {mesh_s:.3f} s, one device "
        f"{one_s:.3f} s; stats G, FY, yty, fsum, ysum "
        f"{', '.join(f'{r:.3e}' for r in stats_rels)} relative; predictions on "
        f"{MESH_PRED_ROWS} rows {pred_rel:.3e}; W, fmean, ymean "
        f"{', '.join(f'{r:.3e}' for r in rels)} (the one-device fit in {shard_rows}-row tiles: "
        f"W {retile_rel:.3e}); launches {counts} ({smi})")
    shard_tiles = MESH_SHARDS * -(-shard_rows // STREAM_TILE)
    want_counts = {"cosine_features": shard_tiles, "gram_sym_acc": shard_tiles}
    check("25(b) the mesh fold's launches: one cosine slab and one gram_sym_acc a shard's tile",
          same_launches(counts, want_counts), f"{counts}, expected {want_counts}")
    check("25(b) gram_stats_mesh's statistics match gram_stats'",
          all(r <= MESH_BCD_TOL for r in stats_rels),
          f"G, FY, yty, fsum, ysum {', '.join(f'{r:.2e}' for r in stats_rels)} "
          f"(tol {MESH_BCD_TOL:.0e})")
    check("25(b) streaming_bcd_fit_mesh_centered's model predicts as streaming_bcd_fit_centered's",
          pred_rel <= MESH_STREAM_TOL and rels[1] <= MESH_BCD_TOL and rels[2] <= MESH_BCD_TOL,
          f"predictions {pred_rel:.2e} (tol {MESH_STREAM_TOL:.0e}), fmean {rels[1]:.2e}, ymean "
          f"{rels[2]:.2e} (tol {MESH_BCD_TOL:.0e}); weights {rels[0]:.2e} (a reading)")
    del X, Y, Xs, Ys, got, want, bank, retiled, rows
    return dict(mesh_seconds=mesh_s, one_device_seconds=one_s, launches=counts, rels=rels,
                stats_rels=stats_rels, predictions_rel=pred_rel, retiled_weights_rel=retile_rel)


def phase_mesh_block_streamed(cuda_ops, timit, TimitConfig, smi, device="cuda"):
    """25(c): the block-streamed tier over the mesh (every kernel on each
    shard's rows, one psum a block step) against its one-device form on
    the same rows, centred, the last 100 rows padding. Held: the means
    (1e-5) and the predictions on the first rows (1e-4); the weights are
    a reading, as in (b)."""
    from keystone_tpu_torch.parallel import mesh as mesh_lib
    from keystone_tpu_torch.parallel import streaming

    mesh = _mesh(device)
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK)
    rfs = timit._cosine_models(config, device)
    Wrf, brf = torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
    del rfs
    n_true = MESH_BLOCK_N - MESH_BLOCK_PAD
    X, Y = _timit_rows(n_true, 5, device)
    pad = MESH_BLOCK_PAD
    Xp = torch.cat([X, torch.zeros((pad, X.shape[1]), device=device)])
    Yp = torch.cat([Y, torch.zeros((pad, Y.shape[1]), device=device)])
    kw = dict(block_size=BLOCK, lam=0.0, num_iter=EPOCHS, center=True)
    Xs, Ys = mesh_lib.shard_rows(Xp, mesh), mesh_lib.shard_rows(Yp, mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = streaming.streaming_block_bcd_mesh(Xs, Ys, Wrf, brf, mesh=mesh, n_true=n_true, **kw)
    _sync(device)
    mesh_s = time.perf_counter() - t0
    counts = _launches_since(cuda_ops)
    t0 = time.perf_counter()
    want = streaming.streaming_block_bcd_mesh(X, Y, Wrf, brf, **kw)
    _sync(device)
    one_s = time.perf_counter() - t0
    rows = X[:MESH_PRED_ROWS]
    pred_rel = _rel(_centred_predictions(cuda_ops, rows, *got, Wrf, brf),
                    _centred_predictions(cuda_ops, rows, *want, Wrf, brf))
    rels = [_rel(g, w) for g, w in zip(got, want)]
    log(f"  (c) n={n_true} (padded to {MESH_BLOCK_N}) on {MESH_SHARDS} shards: mesh fit "
        f"{mesh_s:.3f} s, one device {one_s:.3f} s; predictions on {MESH_PRED_ROWS} rows "
        f"{pred_rel:.3e}; W, fmean, ymean {', '.join(f'{r:.3e}' for r in rels)} relative; "
        f"launches {counts} ({smi})")
    steps = NUM_COSINES * MESH_SHARDS
    want_counts = {"cosine_features": EPOCHS * steps, "gram_corr_sym": steps,
                   "block_corr": (EPOCHS - 1) * steps, "block_residual_update": EPOCHS * steps}
    check("25(c) the block-streamed mesh launches: every kernel once a shard a block step",
          same_launches(counts, want_counts), f"{counts}, expected {want_counts}")
    check("25(c) streaming_block_bcd_mesh over the mesh predicts as its one-device form",
          pred_rel <= MESH_STREAM_TOL and rels[1] <= MESH_BCD_TOL and rels[2] <= MESH_BCD_TOL,
          f"predictions {pred_rel:.2e} (tol {MESH_STREAM_TOL:.0e}), fmean {rels[1]:.2e}, ymean "
          f"{rels[2]:.2e} (tol {MESH_BCD_TOL:.0e}); weights {rels[0]:.2e} (a reading)")
    del X, Y, Xp, Yp, Xs, Ys, got, want, Wrf, brf, rows
    return dict(mesh_seconds=mesh_s, one_device_seconds=one_s, launches=counts, rels=rels,
                predictions_rel=pred_rel)


def phase_mesh_multichip(cuda_ops, smi, device="cuda"):
    """25(d): ``python -m keystone_tpu_torch.tools.multichip``'s leg on
    the card: the padded-COO gram fit on one device and on 8 shards,
    parity within DEFAULT_TOL, the layout a recorded mesh_layout decision
    left unstamped (8 shards share one card: its wall is no outcome of
    the layout), the walls no evidence of scaling. Each leg's launches
    are counted alone: the counts are zeroed just before each fit and
    read just after it, so the mesh path's are the mesh leg's only."""
    import contextlib
    import io

    from keystone_tpu_torch import obs
    from keystone_tpu_torch.obs import tracer as tracer_mod
    from keystone_tpu_torch.ops.learning import lbfgs
    from keystone_tpu_torch.tools import multichip

    legs = {}
    fit = lbfgs.run_lbfgs_gram_streamed

    def counted_fit(*args, **kwargs):
        cuda_ops.reset_launch_counts()
        try:
            return fit(*args, **kwargs)
        finally:
            leg = "mesh" if kwargs.get("mesh") is not None else "one_device"
            legs[leg] = _launches_since(cuda_ops)

    buf = io.StringIO()
    argv = MESH_MC_ARGV + ["--device", str(torch.device(device))]
    lbfgs.run_lbfgs_gram_streamed = counted_fit
    try:
        with obs.tracing() as t, contextlib.redirect_stdout(buf):
            rc = multichip.main(argv)
    finally:
        lbfgs.run_lbfgs_gram_streamed = fit
        tracer_mod._ACTIVE = None
    out = buf.getvalue()
    decisions = [e["args"] for e in t.events if e.get("type") == "event"
                 and e["name"] == "cost.decision" and e["args"]["decision"] == "mesh_layout"]
    parity = [line for line in out.splitlines() if line.startswith("parity")]
    walls = [line for line in out.splitlines() if "wall" in line]
    log(f"  (d) tools.multichip {' '.join(argv)}: rc {rc}; {'; '.join(walls + parity)}; "
        f"launches: mesh leg {legs.get('mesh')}, one-device leg {legs.get('one_device')} "
        f"({smi})")
    check("25(d) tools.multichip: parity within its tolerance, a mesh_layout decision left "
          "unstamped, no speedup claim for shards on one card",
          rc == 0 and "OK" in out and "not device evidence" in out and "speedup" not in out
          and len(decisions) == 1 and decisions[0]["winner"] == "mesh[data=8,model=1]"
          and "outcome" not in decisions[0],
          f"rc {rc}, {parity}, decisions {decisions}")
    # A segment folds seg chunk ids, those past the data with zero values:
    # the one-device fit whole segments of the chunks, each shard whole
    # segments of its ceil(chunks / 8).
    chunks, seg = -(-int(MESH_MC_ARGV[1]) // int(MESH_MC_ARGV[7])), int(MESH_MC_ARGV[9])
    cpd = -(-chunks // MESH_SHARDS)
    local = -(-cpd // min(seg, cpd)) * min(seg, cpd)
    want = {"one_device": -(-chunks // seg) * seg, "mesh": MESH_SHARDS * local}
    got = {leg: legs.get(leg, {}).get("gram_corr_sym_acc") for leg in want}
    check("25(d) gram_corr_sym_acc once a chunk id in each fit, counted leg by leg",
          got == want, f"{legs}, expected {want}")
    return dict(rc=rc, parity=parity, walls=walls, launches=legs.get("mesh", {}),
                one_device_launches=legs.get("one_device", {}),
                decision=decisions[0]["winner"] if decisions else None)



RING = ("ring tier: the mesh KRR sweep and the ring apply at RandomPatchCifarKernel's KRR "
        "width, ring_pairwise_gaussian, ring_gram, ring_attention, profile=True, bf16x3; "
        "HOG, DAISY, RWLS, the streamed ZCA")
# 26(a), (b), (e): RandomPatchCifarKernel's KRR at its own width (phase 6):
# n = 50,000 seeded standard normal rows (the scale of its standardised
# features) of d = 1,800, k = 10 classes as +-1 indicators, blocks of 512
# (98), gamma 5e-4, lambda 10, 1 epoch; 12,500 test rows. 8 shards of 6,250
# rows (the test rows 1,563 a shard, 4 of them padding).
RING_LAM = 10.0
# 26(c): ring_pairwise_gaussian on 16,384 rows (2,048 a shard) of d = 1,800;
# 26(d): ring_gram on 50,000 x 1,800 (225-row stripes), ring_attention at
# n = 16,384, d = 128 (its n_valid leg 16,380 true rows).
RING_PAIRWISE_N, RING_ATTN_N, RING_ATTN_D, RING_ATTN_PAD = 16384, 16384, 128, 4
# Tolerances, set before the first call: the mesh fit's weights 1e-4
# relative Frobenius of the one-device fit's and the ring apply's
# predictions 1e-4 of their scale (the CPU tests'; the psum only
# reassociates each step's residual); kernel entries 1e-5 absolute (phase
# 1's); ring_gram 1e-5 of |F|^T|F| against float64 sums; ring_attention
# 1e-5 absolute against float64 attention; profile=True 2e-4 absolute of
# the fused sweep's weights (the CPU test's).
# Two limits must also fail what they guard against. ring_attention's bf16
# leg: within one bf16 ulp of each float64 output (ulps floored at that of
# 2^-8 max|out|), where float32 state (m, l, acc) and one cast at the end
# give at most half an ulp, and a control with its state rounded to bf16
# after every block must fail it (an H100 read 0.508 and 104.2 ulps).
# bf16x3: 1e-5 relative Frobenius of f32's weights (an H100 read 1.883e-6),
# which a one-pass bf16 fit must fail (1.939e-4).
RING_FIT_TOL, RING_KERNEL_TOL, RING_GRAM_TOL, RING_ATTN_TOL = 1e-4, 1e-5, 1e-5, 1e-5
RING_ATTN_BF16_ULPS, RING_PROFILE_TOL, RING_BF16X3_TOL = 1.0, 2e-4, 1e-5


def _ring_counts(cuda_ops, counts, want, label):
    check(f"26{label} launches", same_launches(counts, want), f"{counts}, expected {want}")


def _gaussian_ring_shape(cuda_ops, label, X, Y, W=None, reps=20):
    """One Gaussian kernel at a shape the ring tier gives it, on the card:
    against its plain version (kernel entries RING_KERNEL_TOL absolute, the
    residual 1e-4 of its scale), its time a call and on the device, the
    plain version's, the library call's and the bound; launches here are
    not the path's."""
    g, dev = CIFAR_GAMMA, X.device
    m, d = X.shape
    n = Y.shape[0]
    xn, yn = (X * X).sum(1), (Y * Y).sum(1)
    xyn = xn[:, None] + yn[None, :]
    if W is None:
        name = "gaussian_kernel_block"
        run = lambda: cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g)
        plain = lambda: cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g)
        library = lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_()
        nbytes, flops = 4 * (m * d + n * d + m + n + m * n), 2 * m * n * d + 6 * m * n
        err = (run() - plain()).abs().max().item()
        ok, detail = err <= RING_KERNEL_TOL, f"max_abs_err {err:.3e} (tol {RING_KERNEL_TOL:.0e})"
        grid = cuda_ops.gaussian_kernel_block_grid(m, n, d, False, dev)
    else:
        k = W.shape[1]
        name = "gaussian_resid_block"
        run = lambda: cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g)
        plain = lambda: cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g)
        library = lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_().T @ W
        nbytes = 4 * (m * d + n * d + m + n + m * k + n * k)
        flops = 2 * m * n * d + 6 * m * n + 2 * m * n * k
        scale = (cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g).T @ W.abs()).max().item()
        err = (run() - plain()).abs().max().item()
        ok = err <= 1e-4 * scale
        detail = f"max_abs_err {err:.3e} ({err / scale:.2e} of scale, tol 1e-4 of scale)"
        grid = cuda_ops.gaussian_resid_block_grid(m, n, d, k, False, dev)
    check(f"26 {name} {label} X {m}x{d} @ Y {n}x{d}", ok, detail)
    r = dict(max_abs_err=err, ms=time_ms(run, reps), device_ms=device_ms(run, reps),
             plain_ms=time_ms(plain, reps), library_ms=time_ms(library, reps), grid=grid)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    log(f"  {name} {label} {m}x{n}x{d}: {r['ms']:.3f} ms a call, {r['device_ms']:.3f} ms on the "
        f"device (plain {r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound "
        f"{r['bound_ms']:.3f} by {r['bound_by']}); grid {grid_line(grid)}")
    return name, r


def phase_ring_shapes(cuda_ops, device="cuda"):
    """26: the two Gaussian kernels at the shard shapes the ring tier gives
    them (8 shards of phase 26's rows): the mesh sweep's residual (a
    6,250-row shard against a 512-row block), the ring apply's (a train
    shard against 1,563 test rows), the ring pairwise step (2,048 x 2,048)
    and the pre-pass's diagonal block (512 x 512, on the first device)."""
    gen = torch.Generator(device=device).manual_seed(26)
    rows = CIFAR_N // MESH_SHARDS
    test_rows = -(-CIFAR_TEST // MESH_SHARDS)
    pair = RING_PAIRWISE_N // MESH_SHARDS
    X = torch.randn((rows, CIFAR_D), generator=gen, device=device)
    B = torch.randn((CIFAR_BLOCK, CIFAR_D), generator=gen, device=device)
    T = torch.randn((test_rows, CIFAR_D), generator=gen, device=device)
    P = torch.randn((pair, CIFAR_D), generator=gen, device=device)
    W = torch.randn((rows, CIFAR_K), generator=gen, device=device) * 0.01
    out = {"gaussian_resid_block": {}, "gaussian_kernel_block": {}}
    for label, args in (("mesh sweep shard", (X, B, W)), ("ring apply step", (X, T, W)),
                        ("ring pairwise step", (P, P)), ("mesh pre-pass diagonal", (B, B))):
        name, r = _gaussian_ring_shape(cuda_ops, label, *args)
        out[name][label] = r
    del X, B, T, P, W
    return out


def _krr_rows(n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, CIFAR_D), generator=gen, device=device)
    cls = torch.randint(0, CIFAR_K, (n,), generator=gen, device=device)
    Y = 2.0 * torch.nn.functional.one_hot(cls, CIFAR_K).to(torch.float32) - 1.0
    return X, Y


def _krr_est(kernel, kernel_dtype="f32", **kw):
    return kernel.KernelRidgeRegression(kernel.GaussianKernelGenerator(CIFAR_GAMMA, kernel_dtype),
                                        RING_LAM, CIFAR_BLOCK, 1, **kw)


def _stack(model):
    return torch.stack([w.to(torch.float32) for w in model.w_locals])


def phase_ring_krr(cuda_ops, smi, device="cuda"):
    """26(a), (b), (e): KernelRidgeRegression at RandomPatchCifarKernel's KRR
    width on one device, then on rows sharded over 8 shards of the card
    (the mesh sweep: gaussian_resid_block once a shard a step, the
    pre-pass's gaussian_kernel_block once a block on the first device), its
    weights against the one-device fit's; the ring apply of the mesh model
    on 12,500 test rows against its one-device apply; one profile=True
    epoch (phases and a line a block logged) and a bf16x3 fit against the
    f32 fused fit. Each part's launches counted from 0."""
    import logging

    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning import kernel

    mesh = _mesh(device)
    X, Y = _krr_rows(CIFAR_N, 261, device)
    Xt, _ = _krr_rows(CIFAR_TEST, 262, device)
    out = {}
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    one = _krr_est(kernel).fit(Dataset(X), Dataset(Y))
    _sync(device)
    out["one_device_fit_seconds"] = time.perf_counter() - t0
    out["one_device_launches"] = _launches_since(cuda_ops)
    data, labels = Dataset(X).shard(mesh), Dataset(Y).shard(mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = _krr_est(kernel).fit(data, labels)
    _sync(device)
    out["fit_seconds"] = time.perf_counter() - t0
    fit_counts = out["fit_launches"] = _launches_since(cuda_ops)
    rel = out["weights_rel"] = _rel(_stack(model), _stack(one))
    log(f"  (a) mesh KRR fit, {MESH_SHARDS} shards of {CIFAR_N // MESH_SHARDS} rows, "
        f"d={CIFAR_D}, k={CIFAR_K}, {CIFAR_BLOCKS} blocks of {CIFAR_BLOCK}, 1 epoch: "
        f"{out['fit_seconds']:.3f} s (one device {out['one_device_fit_seconds']:.3f} s, "
        f"launches {out['one_device_launches']}); weights {rel:.3e} relative to the one-device "
        f"fit's; launches {fit_counts} ({smi})")
    _ring_counts(cuda_ops, fit_counts, {"gaussian_resid_block": CIFAR_BLOCKS * MESH_SHARDS,
                                        "gaussian_kernel_block": CIFAR_BLOCKS},
                 "(a) the mesh sweep: gaussian_resid_block once a shard a step, the pre-pass's "
                 "gaussian_kernel_block once a block")
    check("26(a) the mesh fit's weights match the one-device fit's", rel <= RING_FIT_TOL,
          f"{rel:.2e} relative Frobenius (tol {RING_FIT_TOL:.0e})")
    del data, labels
    want = model.batch_apply(Dataset(Xt)).array
    test = Dataset(Xt).shard(mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = model.batch_apply(test)
    _sync(device)
    out["apply_seconds"] = time.perf_counter() - t0
    apply_counts = out["apply_launches"] = _launches_since(cuda_ops)
    got = got.array.gather()[:CIFAR_TEST]
    err = (got - want).abs().max().item() / want.abs().max().item()
    out["apply_rel"] = err
    log(f"  (b) ring apply of the mesh model on {CIFAR_TEST} test rows: "
        f"{out['apply_seconds']:.3f} s, predictions {err:.3e} of their scale from its "
        f"one-device apply; launches {apply_counts} ({smi})")
    _ring_counts(cuda_ops, apply_counts, {"gaussian_resid_block": MESH_SHARDS * MESH_SHARDS},
                 "(b) the ring apply: gaussian_resid_block once a shard a step")
    check("26(b) the ring apply matches the one-device apply", err <= RING_FIT_TOL,
          f"{err:.2e} of the predictions' scale (tol {RING_FIT_TOL:.0e})")
    del got, want, test, model

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler, root = Keep(), logging.getLogger("keystone_tpu_torch")
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        prof = _krr_est(kernel, profile=True).fit(Dataset(X), Dataset(Y))
        _sync(device)
        out["profile_seconds"] = time.perf_counter() - t0
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    prof_counts = out["profile_launches"] = _launches_since(cuda_ops)
    blocks = [m for m in records if m.startswith("EPOCH_0_BLOCK_")]
    summary = [m for m in records if m.startswith("krr_fit:")]
    err = out["profile_abs"] = (_stack(prof) - _stack(one)).abs().max().item()
    out["profile_summary"] = summary[0] if summary else None
    log(f"  (e) profile=True, 1 epoch: {out['profile_seconds']:.3f} s, {len(blocks)} block "
        f"lines (first {blocks[:1]}), {summary}; weights {err:.3e} from the fused sweep's; "
        f"launches {prof_counts} ({smi})")
    _ring_counts(cuda_ops, prof_counts, {"gaussian_kernel_block": 2 * CIFAR_BLOCKS},
                 "(e) profile=True: a column and a diagonal block a step")
    check("26(e) profile=True logs a line a block and its phases, and matches the fused sweep",
          len(blocks) == CIFAR_BLOCKS and len(summary) == 1 and "kernel_gen=" in summary[0]
          and "block_solve=" in summary[0] and err <= RING_PROFILE_TOL,
          f"{len(blocks)} lines, {summary}, {err:.2e} absolute (tol {RING_PROFILE_TOL:.0e})")
    del prof
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    b3 = _krr_est(kernel, "bf16x3").fit(Dataset(X), Dataset(Y))
    _sync(device)
    out["bf16x3_seconds"] = time.perf_counter() - t0
    out["bf16x3_launches"] = _launches_since(cuda_ops)
    rel = out["bf16x3_rel"] = _rel(_stack(b3), _stack(one))
    _ring_counts(cuda_ops, out["bf16x3_launches"], {}, "(e) bf16x3: no Gaussian kernel")
    del b3
    ctl = out["bf16_control_rel"] = _rel(_stack(_krr_est(kernel, "bf16").fit(
        Dataset(X), Dataset(Y))), _stack(one))
    log(f"  (e) bf16x3 fit: {out['bf16x3_seconds']:.3f} s, weights {rel:.3e} relative to the "
        f"f32 fit's (a one-pass bf16 fit's {ctl:.3e}); launches {out['bf16x3_launches']} "
        f"({smi})")
    check("26(e) the bf16x3 fit tracks the f32 fit, and a one-pass bf16 fit does not",
          rel <= RING_BF16X3_TOL < ctl,
          f"{rel:.2e} relative Frobenius (tol {RING_BF16X3_TOL:.0e}; bf16 control {ctl:.2e})")
    del one, X, Y, Xt
    return out


def _attention_f64(Q, K, V, causal, n):
    Q, K, V = (a[:n].to(torch.float64) for a in (Q, K, V))
    s = (Q @ K.T) / Q.shape[1] ** 0.5
    if causal:
        s.masked_fill_(torch.ones_like(s, dtype=torch.bool).triu_(1), float("-inf"))
    return torch.softmax(s, dim=1) @ V


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of each float64 value, the ulp floored
    at that of 2^-8 of max|want| (below it float32 sums' own noise would
    count)."""
    mag = torch.clamp_min(want.abs(), want.abs().max().item() * 2.0 ** -8)
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def _attention_bf16_state(Q, K, V, p):
    """Softmax attention by the ring's online softmax over p key blocks,
    its state (m, l, acc) rounded to bf16 after every block: the control
    the bf16 leg's limit must fail."""
    ln, sc = Q.shape[0] // p, Q.shape[1] ** -0.5
    outs = []
    for me in range(p):
        q = Q[me * ln:(me + 1) * ln].float()
        m = torch.full((ln,), -1e30, device=Q.device)
        l_ = torch.zeros((ln,), device=Q.device)
        acc = torch.zeros((ln, V.shape[1]), device=Q.device)
        for src in ((me - step) % p for step in range(p)):
            s = (q @ K[src * ln:(src + 1) * ln].float().T) * sc
            m_new = torch.maximum(m, s.max(dim=1).values).bfloat16().float()
            alpha = torch.exp(m - m_new)
            p_blk = torch.exp(s - m_new[:, None])
            l_ = (l_ * alpha + p_blk.sum(dim=1)).bfloat16().float()
            acc = (acc * alpha[:, None] + p_blk @ V[src * ln:(src + 1) * ln].float()
                   ).bfloat16().float()
            m = m_new
        outs.append((acc / l_[:, None]).bfloat16())
    return torch.cat(outs)


def phase_ring_primitives(cuda_ops, smi, device="cuda"):
    """26(c), (d): ring_pairwise_gaussian on 16,384 rows against one
    gaussian_kernel_block over all of them (its launches counted from 0:
    one a shard a step); ring_gram on 50,000 x 1,800 against float64 sums;
    ring_attention at n = 16,384, d = 128, causal, with n_valid, and with
    bf16 operands, against float64 softmax attention (the bf16 leg in bf16
    ulps, beside a bf16-state control that must fail it)."""
    from keystone_tpu_torch.parallel import mesh as mesh_lib
    from keystone_tpu_torch.parallel import ring

    mesh = _mesh(device)
    out = {}
    gen = torch.Generator(device=device).manual_seed(263)
    P = torch.randn((RING_PAIRWISE_N, CIFAR_D), generator=gen, device=device)
    shards = mesh_lib.shard_rows(P, mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    K = ring.ring_pairwise_gaussian(shards, CIFAR_GAMMA, mesh)
    _sync(device)
    out["pairwise_seconds"] = time.perf_counter() - t0
    counts = out["pairwise_launches"] = _launches_since(cuda_ops)
    pn = (P * P).sum(1)
    t0 = time.perf_counter()
    full = cuda_ops.gaussian_kernel_block(P, P, pn, pn, CIFAR_GAMMA)
    _sync(device)
    out["one_launch_seconds"] = time.perf_counter() - t0
    rows = K.shard_rows
    err = out["pairwise_max_abs_err"] = max(
        (s - full[j * rows:(j + 1) * rows]).abs().max().item() for j, s in enumerate(K.shards))
    nbytes = sum(s.numel() * s.element_size() for s in K.shards)
    log(f"  (c) ring_pairwise_gaussian {RING_PAIRWISE_N} x {CIFAR_D} over {MESH_SHARDS} shards: "
        f"{out['pairwise_seconds']:.3f} s (one launch over all rows "
        f"{out['one_launch_seconds']:.3f} s), output {nbytes / 1e9:.3f} GB, max_abs_err "
        f"{err:.3e} against the one launch; launches {counts} ({smi})")
    _ring_counts(cuda_ops, counts, {"gaussian_kernel_block": MESH_SHARDS * MESH_SHARDS},
                 "(c) ring_pairwise_gaussian: gaussian_kernel_block once a shard a step")
    check("26(c) the ring's kernel matches one launch over all rows", err <= RING_KERNEL_TOL,
          f"max_abs_err {err:.2e} (tol {RING_KERNEL_TOL:.0e})")
    del P, shards, K, full, pn
    torch.cuda.empty_cache()

    F = torch.randn((CIFAR_N, CIFAR_D), generator=gen, device=device)
    t0 = time.perf_counter()
    G = ring.ring_gram(mesh_lib.shard_rows(F, mesh), mesh)
    _sync(device)
    out["gram_seconds"] = time.perf_counter() - t0
    want = F.to(torch.float64).T @ F.to(torch.float64)
    scale = F.abs().T @ F.abs()
    stripe = G.shard_rows
    err = out["gram_rel"] = max(
        ((s.to(torch.float64) - want[j * stripe:(j + 1) * stripe]).abs()
         / scale[j * stripe:(j + 1) * stripe]).max().item() for j, s in enumerate(G.shards))
    log(f"  (d) ring_gram {CIFAR_N} x {CIFAR_D}: {stripe}-row stripes, {out['gram_seconds']:.3f} "
        f"s, {err:.3e} of |F|^T|F| from float64 sums ({smi})")
    check("26(d) ring_gram: 225-row stripes within tolerance of float64 sums",
          stripe == CIFAR_D // MESH_SHARDS and err <= RING_GRAM_TOL,
          f"{stripe} rows a stripe, {err:.2e} of scale (tol {RING_GRAM_TOL:.0e})")
    del F, G, want, scale
    torch.cuda.empty_cache()

    n, d = RING_ATTN_N, RING_ATTN_D
    Q, Kt, V = (torch.randn((n, d), generator=gen, device=device) for _ in range(3))
    legs = {}
    for leg, causal, n_valid, dtype in (("causal", True, None, torch.float32),
                                        ("n_valid", False, n - RING_ATTN_PAD, torch.float32),
                                        ("bf16 operands", False, None, torch.bfloat16)):
        ops = [a.to(dtype, copy=True) for a in (Q, Kt, V)]
        if n_valid is not None:
            for a in ops:
                a[n_valid:] = 0  # the mesh's zero padding
        t0 = time.perf_counter()
        got = ring.ring_attention(*(mesh_lib.shard_rows(a, mesh) for a in ops), mesh=mesh,
                                  causal=causal, n_valid=n_valid)
        _sync(device)
        secs = time.perf_counter() - t0
        got = got.gather().to(torch.float64)
        nv = n if n_valid is None else n_valid
        want = _attention_f64(*ops, causal, nv)
        err = (got[:nv] - want).abs().max().item()
        pad_zero = bool((got[nv:] == 0).all())
        legs[leg] = dict(seconds=secs, max_abs_err=err, max_abs_out=want.abs().max().item())
        if dtype == torch.bfloat16:
            ulps = legs[leg]["ulps"] = _bf16_ulps(got[:nv], want)
            ctl = legs[leg]["control_ulps"] = _bf16_ulps(
                _attention_bf16_state(*ops, MESH_SHARDS).to(torch.float64), want)
            ok = ulps <= RING_ATTN_BF16_ULPS < ctl
            detail = (f"{ulps:.3f} bf16 ulps (tol {RING_ATTN_BF16_ULPS:.0f}; bf16-state "
                      f"control {ctl:.3f})")
        else:
            ok, detail = err <= RING_ATTN_TOL, f"max_abs_err {err:.2e} (tol {RING_ATTN_TOL:.0e})"
        log(f"  (d) ring_attention {leg} n={n}, d={d}: {secs:.3f} s, max_abs_err {err:.3e} "
            f"(max|out| {legs[leg]['max_abs_out']:.3e}) against float64 attention; {detail}")
        check(f"26(d) ring_attention {leg}", ok and pad_zero,
              f"{detail}; padded rows zero: {pad_zero}")
        del ops, got, want
    out["attention"] = legs
    del Q, Kt, V
    torch.cuda.empty_cache()
    return out


# 26(f): the modules no default route takes, each once on the card against
# the same call on the CPU: HOG (bins of 4) and DAISY (its defaults but a
# border of 8 pixels, which leaves 16 keypoints on a 32 x 32 image) on 1,000
# synthetic CIFAR images; PerClassWeightedLeastSquaresEstimator at VOC's
# 5,011 x 4,096 with 20 classes (one block of 4,096, 1 pass, lambda 0.5,
# mixture weight 0.25); StreamedZCAWhitenerEstimator on CIFAR's 6 x 6 x 3
# patches, 10 of each of 50,000 synthetic images (500,000 rows), from disk
# shards of 16,384-row tiles, 2 a segment. Tolerances, set before the first
# call: HOG and DAISY 1e-4 absolute (float32 sums in other orders, the
# card's scatter-add in atomics); RWLS 1e-4 relative Frobenius of the
# weights and intercept (lambda 0.5 keeps each class's system well
# conditioned); the ZCA whitener 1e-3 absolute (float32 eigensolves on two
# devices) and its means 1e-6 of their scale: the patches are pixels in
# [0, 255], so float32 sums of 500,000 of them in two orders part by about
# 1e-7 of the means (an absolute 1e-5, set at first, read 1.53e-5 there).
OPT_IMAGES, OPT_VOC_N, OPT_VOC_D, OPT_VOC_K = 1000, 5011, 4096, 20
OPT_ZCA_IMAGES, OPT_ZCA_PER_IMAGE, OPT_ZCA_TILE = 50000, 10, 16384
OPT_IMAGE_TOL, OPT_RWLS_TOL, OPT_ZCA_MEAN_TOL, OPT_ZCA_TOL = 1e-4, 1e-4, 1e-6, 1e-3


def _both_devices(fn, device):
    """``fn(device)`` on the card (synchronized, timed) and on the CPU."""
    _sync(device)
    t0 = time.perf_counter()
    got = fn(device)
    _sync(device)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fn("cpu")
    return got, want, secs, time.perf_counter() - t0


def phase_ring_options(root, smi, device="cuda"):
    """26(f): HOG, DAISY, PerClassWeightedLeastSquaresEstimator and
    StreamedZCAWhitenerEstimator once on the card at a realistic size, each
    against the same call on the CPU (see OPT_*)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.loaders import synthetic_cifar
    from keystone_tpu_torch.data.shards import DiskDenseShards
    from keystone_tpu_torch.ops.images import DaisyExtractor, HogExtractor
    from keystone_tpu_torch.ops.learning.pca import StreamedZCAWhitenerEstimator
    from keystone_tpu_torch.ops.learning.rwls import PerClassWeightedLeastSquaresEstimator

    out = {}
    images = synthetic_cifar(OPT_IMAGES, seed=264, device="cpu").data.array
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32) / 255.0
    for name, node in (("hog", HogExtractor(4)), ("daisy", DaisyExtractor(pixel_border=8))):
        got, want, secs, cpu_secs = _both_devices(
            lambda dev: node.batch_apply(Dataset(images.to(dev))).array.cpu(), device)
        err = (got - want).abs().max().item()
        out[name] = dict(seconds=secs, cpu_seconds=cpu_secs, max_abs_err=err,
                         shape=list(got.shape))
        log(f"  (f) {name} on {OPT_IMAGES} 32 x 32 x 3 images: {tuple(got.shape)}, card "
            f"{secs:.3f} s, CPU {cpu_secs:.3f} s, max_abs_err {err:.3e} ({smi})")
        check(f"26(f) {name} on the card against the CPU",
              err <= OPT_IMAGE_TOL and bool(torch.isfinite(got).all()) and got.abs().sum() > 0,
              f"max_abs_err {err:.2e} (tol {OPT_IMAGE_TOL:.0e})")
    del images

    rng = np.random.default_rng(265)
    X = rng.normal(size=(OPT_VOC_N, OPT_VOC_D)).astype(np.float32)
    Y = (2.0 * np.eye(OPT_VOC_K)[rng.integers(0, OPT_VOC_K, OPT_VOC_N)] - 1.0).astype(np.float32)

    def rwls(dev):
        model = PerClassWeightedLeastSquaresEstimator(OPT_VOC_D, 1, 0.5, 0.25).fit(
            Dataset(torch.from_numpy(X).to(dev)), Dataset(torch.from_numpy(Y).to(dev)))
        return torch.cat([model.xs[0].reshape(-1), model.b_opt]).cpu()

    got, want, secs, cpu_secs = _both_devices(rwls, device)
    rel = _rel(got, want)
    out["rwls"] = dict(seconds=secs, cpu_seconds=cpu_secs, rel=rel)
    log(f"  (f) PerClassWeightedLeastSquaresEstimator {OPT_VOC_N} x {OPT_VOC_D}, "
        f"{OPT_VOC_K} classes: card {secs:.3f} s, CPU {cpu_secs:.3f} s, weights and intercept "
        f"{rel:.3e} relative ({smi})")
    check("26(f) RWLS on the card against the CPU", rel <= OPT_RWLS_TOL,
          f"{rel:.2e} relative Frobenius (tol {OPT_RWLS_TOL:.0e})")
    del X, Y

    cifar = synthetic_cifar(OPT_ZCA_IMAGES, seed=266, device="cpu").data.array
    cifar = np.asarray(cifar, dtype=np.float32)
    at = rng.integers(0, 32 - 6 + 1, size=(2, OPT_ZCA_IMAGES, OPT_ZCA_PER_IMAGE))
    offs = np.arange(6)
    rows = np.arange(OPT_ZCA_IMAGES)[:, None, None, None]
    xi = (at[0][..., None, None] + offs[:, None])  # (n, p, 6, 1)
    yi = (at[1][..., None, None] + offs[None, :])  # (n, p, 1, 6)
    patches = cifar[rows, xi, yi].reshape(-1, 6 * 6 * 3)
    del cifar
    shards = DiskDenseShards.write(os.path.join(root, "zca"), patches,
                                   np.zeros((patches.shape[0], 1), np.float32),
                                   tile_rows=OPT_ZCA_TILE, tiles_per_segment=2)
    del patches
    got, want, secs, cpu_secs = _both_devices(
        lambda dev: StreamedZCAWhitenerEstimator(eps=0.1, device=dev).fit_source(
            shards.as_source()), device)
    mean_err = ((got.means.cpu() - want.means).abs().max() / want.means.abs().max()).item()
    err = (got.whitener.cpu() - want.whitener).abs().max().item()
    out["zca"] = dict(seconds=secs, cpu_seconds=cpu_secs, means_rel=mean_err,
                      whitener_max_abs_err=err, rows=shards.n_true,
                      segments=shards.num_segments)
    log(f"  (f) StreamedZCAWhitenerEstimator on {shards.n_true} 6 x 6 x 3 patches from "
        f"{shards.num_segments} disk segments: card {secs:.3f} s, CPU {cpu_secs:.3f} s; means "
        f"{mean_err:.3e} of their scale, whitener {err:.3e} max_abs_err ({smi})")
    check("26(f) the streamed ZCA on the card against the CPU",
          mean_err <= OPT_ZCA_MEAN_TOL and err <= OPT_ZCA_TOL,
          f"means {mean_err:.2e} (tol {OPT_ZCA_MEAN_TOL:.0e}), whitener {err:.2e} "
          f"(tol {OPT_ZCA_TOL:.0e})")
    return out



MULTI = ("multi-process mesh: two processes on one card (gloo), the KRR sweep, the ring apply, "
         "the normal equations and the n-gram exchange; tools.multichip --scaling; the hybrid "
         "compressed fold; compiled_cost")
# 27(a): two fresh interpreters (this script with --phase27-worker), each
# joining a gloo group through a file:// store and driving 4 shards on
# cuda:0 under make_hybrid_mesh((4,), (2,), ("data",)): phase 26's KRR
# geometry (n = 50,000, d = 1,800, k = 10, 98 blocks of 512, gamma 5e-4,
# lambda 10, 1 epoch; 12,500 test rows), each process keeping its half of
# the seeded rows. Held bit for bit to this process's 8-shard mesh on the
# same rows. NCCL refuses two ranks on one device, so the group is gloo.
MULTI_PROCESSES, MULTI_LOCAL_SHARDS = 2, 4
MULTI_WORKER_TIMEOUT_S = 300
# The _WORKER solve on the card: float64 rows of A (8,192 x 256) and B
# (x 8), data across the processes and model within each (a 2 x 2 hybrid
# mesh), within 1e-9 of float64 numpy (the reference test's tolerance).
MULTI_SOLVE_N, MULTI_SOLVE_D, MULTI_SOLVE_K, MULTI_SOLVE_TOL = 8192, 256, 8, 1e-9
# The _LM_WORKER exchange: 2,000 sentences of 12 word ids in 1..999, the
# bigrams and trigrams split between the processes; scores within 1e-12.
MULTI_LM_SENTENCES, MULTI_LM_VOCAB, MULTI_LM_TOL = 2000, 1000, 1e-12
# 27(b): tools.multichip --scaling at phase 25(d)'s geometry, 1 rep a leg.
MULTI_SCALING_ARGV = MESH_MC_ARGV + ["--scaling", "--reps", "1"]
# 27(c): the hybrid compressed fold at the reference bench's Amazon
# geometry (bench.py:2228-2245): d = 16,384 and the intercept lane, 82
# active lanes a row, k = 2, chunks of 65,536 rows, bf16 values, lambda
# 1e-3, 20 iterations, segments of 16 chunks. Depth cut: 64 chunks
# (4,194,304 rows) instead of 992; 27 resident (the reference's 28/65
# share), 37 streamed from disk shards (3 segments, the last ragged).
HYBRID_CHUNKS, HYBRID_RESIDENT, HYBRID_SEG = 64, 27, 16
# 27(d): compiled_cost of a 4,096 x 4,096 x 4,096 product on the card.
COST_M = COST_N = COST_K = 4096


def _multi_rows(n_total, pid, seed, device):
    """Process ``pid``'s half of phase 27's seeded rows: the whole set made
    from one generator, as every process makes it, and cut."""
    X, Y = _krr_rows(n_total, seed, device)
    half = n_total // MULTI_PROCESSES
    return X[pid * half:(pid + 1) * half], Y[pid * half:(pid + 1) * half]


def _hold_gaussian(cuda_ops, X, Y, W=None):
    """One Gaussian kernel call at a shape the multi-process path gives it
    against its plain version: entries 1e-5 absolute (phase 1's), the
    residual 1e-4 of its scale (phase 26's)."""
    g = CIFAR_GAMMA
    xn, yn = (X * X).sum(1), (Y * Y).sum(1)
    if W is None:
        err = (cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g)
               - cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g)).abs().max().item()
        return dict(max_abs_err=err, ok=err <= RING_KERNEL_TOL)
    scale = (cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g).T @ W.abs()).max().item()
    err = (cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g)
           - cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g)).abs().max().item()
    return dict(max_abs_err=err, ok=err <= 1e-4 * scale, scale=scale)


def phase27_worker(store, pid, outdir, device="cuda"):
    """27(a), one of the two processes: join the group, fit the KRR on its
    half of the rows over its 4 shards, apply the model to its half of the
    test rows by the ring, gather the predictions, hold each kernel it
    launched to its plain version at its shapes, then the _WORKER solve and
    the _LM_WORKER exchange. Writes its results under ``outdir``."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.ops.learning import kernel
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    pid = int(pid)
    out = {"pid": pid}
    t0 = time.perf_counter()
    mesh_lib.init_distributed(f"file://{store}", num_processes=MULTI_PROCESSES, process_id=pid,
                              backend="gloo", timeout_s=MULTI_WORKER_TIMEOUT_S)
    out["join_s"] = time.perf_counter() - t0
    mesh = mesh_lib.make_hybrid_mesh((MULTI_LOCAL_SHARDS,), (MULTI_PROCESSES,),
                                     (mesh_lib.DATA_AXIS,), devices=[device])
    assert mesh.local_shards(mesh_lib.DATA_AXIS) == list(
        range(pid * MULTI_LOCAL_SHARDS, (pid + 1) * MULTI_LOCAL_SHARDS))
    X, Y = _multi_rows(CIFAR_N, pid, 271, device)
    data = Dataset(mesh_lib.shard_local_rows(X, mesh), n=CIFAR_N, mesh=mesh)
    labels = Dataset(mesh_lib.shard_local_rows(Y, mesh), n=CIFAR_N, mesh=mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = _krr_est(kernel).fit(data, labels)
    _sync(device)
    out["fit_s"] = time.perf_counter() - t0
    out["fit_launches"] = _launches_since(cuda_ops)
    np.save(os.path.join(outdir, f"stack{pid}.npy"), _stack(model).cpu().numpy())
    Xt, _ = _krr_rows(CIFAR_TEST, 272, device)
    Xt, _ = mesh_lib.pad_rows(Xt, MULTI_PROCESSES * MULTI_LOCAL_SHARDS)
    half = Xt.shape[0] // MULTI_PROCESSES
    test = Dataset(mesh_lib.shard_local_rows(Xt[pid * half:(pid + 1) * half], mesh),
                   n=CIFAR_TEST, mesh=mesh)
    _sync(device)
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    pred = model.batch_apply(test).array
    _sync(device)
    out["apply_s"] = time.perf_counter() - t0
    out["apply_launches"] = _launches_since(cuda_ops)
    local = torch.cat(pred.shards).cpu().numpy()
    if pid == 0:
        np.save(os.path.join(outdir, "pred.npy"),
                mesh_lib.process_allgather(local).reshape(-1, CIFAR_K))
    else:
        mesh_lib.process_allgather(local)
    try:
        pred.gather()
        out["gather_refused"] = False
    except RuntimeError as e:
        out["gather_refused"] = "process_allgather" in str(e)
    # The kernels this process launched, at its shapes (launches here are
    # checks, not the path's).
    rows = data.array.shard_rows
    xs = data.array.shards[0]
    W = torch.randn((rows, CIFAR_K), device=device) * 0.01
    out["kernel_checks"] = {
        "gaussian_resid_block sweep shard": _hold_gaussian(cuda_ops, xs, X[:CIFAR_BLOCK], W),
        "gaussian_resid_block ring apply step": _hold_gaussian(cuda_ops, xs, test.array.shards[0],
                                                               W),
        "gaussian_kernel_block pre-pass diagonal": _hold_gaussian(cuda_ops, X[:CIFAR_BLOCK],
                                                                  X[:CIFAR_BLOCK]),
    }
    del model, data, labels, X, Y, Xt, test, pred, W
    # The _WORKER solve: data across the processes, model within each.
    m2 = mesh_lib.make_hybrid_mesh((1, 2), (MULTI_PROCESSES, 1),
                                   (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS), devices=[device])
    rng = np.random.default_rng(0)
    A = rng.normal(size=(MULTI_SOLVE_N, MULTI_SOLVE_D))
    B = rng.normal(size=(MULTI_SOLVE_N, MULTI_SOLVE_K))
    rows = MULTI_SOLVE_N // MULTI_PROCESSES
    mine = slice(pid * rows, (pid + 1) * rows)
    A_sh = mesh_lib.shard_local_rows(torch.from_numpy(A[mine]).to(device), m2)
    B_sh = mesh_lib.shard_local_rows(torch.from_numpy(B[mine]).to(device), m2)
    t0 = time.perf_counter()
    Wsol = linalg.normal_equations_solve(A_sh, B_sh, lam=1e-3)
    _sync(device)
    out["solve_s"] = time.perf_counter() - t0
    want = np.linalg.solve(A.T @ A + 1e-3 * np.eye(MULTI_SOLVE_D), A.T @ B)
    out["solve_dtype"] = str(Wsol.dtype)
    out["solve_device"] = str(Wsol.device)
    out["solve_err"] = float(np.abs(Wsol.cpu().numpy() - want).max())
    # The _LM_WORKER exchange: counts as one int64 array a process.
    from keystone_tpu_torch.ops.nlp import (
        NGram, NGramsFeaturizer, ShardedStupidBackoffModel, StupidBackoffEstimator,
        pack_ngram_pairs, partition_ngram_pairs, unpack_ngram_pairs)

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    sents = [rng.integers(1, MULTI_LM_VOCAB, size=12).tolist()
             for _ in range(MULTI_LM_SENTENCES)]
    feats = NGramsFeaturizer([2, 3])
    all_pairs, unigrams = [], {}
    for s in sents:
        for w in s:
            unigrams[w] = unigrams.get(w, 0) + 1
        for g in feats.apply(s):
            all_pairs.append((NGram(g), 1))
    packed = pack_ngram_pairs(all_pairs[pid::MULTI_PROCESSES])
    m = -(-len(all_pairs) // MULTI_PROCESSES)
    packed = np.vstack([packed, np.zeros((m - packed.shape[0], 2), dtype=np.int64)])
    gathered = mesh_lib.process_allgather(packed)
    pairs = [p for part in gathered for p in unpack_ngram_pairs(part[part[:, 1] > 0])]
    parts = partition_ngram_pairs(pairs, MULTI_PROCESSES)
    est = StupidBackoffEstimator(unigrams)
    my_model = est.fit(Dataset.of(parts[pid]))
    full = est.fit(Dataset.of(all_pairs))
    sizes = mesh_lib.process_allgather(np.array([len(my_model.scores)]))
    sharded = ShardedStupidBackoffModel([est.fit(Dataset.of(p)) for p in parts])
    out["lm"] = dict(
        pairs=len(all_pairs), partition=len(my_model.scores), table=len(full.scores),
        tiles=int(sizes.sum()) == len(full.scores),
        worst=max(abs(s - full.scores[g]) for g, s in my_model.scores.items()),
        serve_worst=max(abs(sharded.score(g) - full.score(g)) for g in list(full.scores)[:200]),
        seconds=time.perf_counter() - t0)
    with open(os.path.join(outdir, f"worker{pid}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def phase_multi_krr(cuda_ops, root, smi, device="cuda"):
    """27(a): the KRR fit and its ring apply at phase 26's geometry on 8
    shards of this process (the reference), then the same on two processes
    of 4 shards each (the parent builds every kernel first, so the children
    only load them), each held bit for bit to the one-process forms; the
    children's launches counted in each child around its fit and apply."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.ops.learning import kernel

    out = {}
    mesh = _mesh(device)
    X, Y = _krr_rows(CIFAR_N, 271, device)
    Xt, _ = _krr_rows(CIFAR_TEST, 272, device)
    _sync(device)
    t0 = time.perf_counter()
    model = _krr_est(kernel).fit(Dataset(X).shard(mesh), Dataset(Y).shard(mesh))
    _sync(device)
    out["one_process_fit_s"] = time.perf_counter() - t0
    want_stack = _stack(model).cpu().numpy()
    want_pred = model.batch_apply(Dataset(Xt).shard(mesh)).array.gather()[:CIFAR_TEST].cpu()
    del model, X, Y, Xt
    torch.cuda.empty_cache()
    outdir = os.path.join(root, "multi")
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(outdir, "store")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(key, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase27-worker",
                               store, str(pid), outdir, str(torch.device(device))], env=env,
                              cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(MULTI_PROCESSES)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=MULTI_WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["children_wall_s"] = time.perf_counter() - t0
    for pid, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            log(text[-4000:])
        check(f"27(a) process {pid} ran to its end", p.returncode == 0, f"rc {p.returncode}")
    workers = []
    for pid in range(MULTI_PROCESSES):
        with open(os.path.join(outdir, f"worker{pid}.json")) as f:
            workers.append(json.load(f))
    stacks = [np.load(os.path.join(outdir, f"stack{pid}.npy")) for pid in range(MULTI_PROCESSES)]
    pred = np.load(os.path.join(outdir, "pred.npy"))[:CIFAR_TEST]
    fit_want = {"gaussian_resid_block": CIFAR_BLOCKS * MULTI_LOCAL_SHARDS,
                "gaussian_kernel_block": CIFAR_BLOCKS}
    apply_want = {"gaussian_resid_block": MESH_SHARDS * MULTI_LOCAL_SHARDS}
    for w in workers:
        log(f"  (a) process {w['pid']}: joined in {w['join_s']:.3f} s; fit {w['fit_s']:.3f} s, "
            f"launches {w['fit_launches']}; ring apply {w['apply_s']:.3f} s, launches "
            f"{w['apply_launches']}; solve {w['solve_s']:.3f} s ({w['solve_dtype']} on "
            f"{w['solve_device']}), max |dW| {w['solve_err']:.3e} against float64 numpy; LM "
            f"{w['lm']}; kernel checks {w['kernel_checks']} ({smi})")
        check(f"27(a) process {w['pid']}'s fit launches", same_launches(w["fit_launches"],
                                                                        fit_want),
              f"{w['fit_launches']}, expected {fit_want}")
        check(f"27(a) process {w['pid']}'s ring apply launches",
              same_launches(w["apply_launches"], apply_want),
              f"{w['apply_launches']}, expected {apply_want}")
        for label, r in w["kernel_checks"].items():
            check(f"27(a) process {w['pid']} {label} against its plain version", r["ok"],
                  f"max_abs_err {r['max_abs_err']:.3e}")
        check(f"27(a) process {w['pid']}'s sharded predictions refuse a gather",
              w["gather_refused"], "RuntimeError naming process_allgather")
        check(f"27(a) process {w['pid']}'s normal-equations solve",
              w["solve_dtype"] == "torch.float64"
              and w["solve_device"].startswith(torch.device(device).type)
              and w["solve_err"] <= MULTI_SOLVE_TOL,
              f"{w['solve_err']:.3e} (tol {MULTI_SOLVE_TOL:.0e}), {w['solve_dtype']}")
        lm = w["lm"]
        check(f"27(a) process {w['pid']}'s n-gram exchange",
              lm["tiles"] and lm["worst"] <= MULTI_LM_TOL and lm["serve_worst"] <= MULTI_LM_TOL,
              f"{lm}")
    for pid, stack in enumerate(stacks):
        check(f"27(a) process {pid}'s weight stack has the one-process 8-shard fit's bits",
              np.array_equal(stack, want_stack),
              f"max |d| {np.abs(stack - want_stack).max():.3e}")
    check("27(a) the two-process ring apply has the one-process ring apply's bits",
          np.array_equal(pred, want_pred.numpy()),
          f"max |d| {np.abs(pred - want_pred.numpy()).max():.3e}")
    out["workers"] = workers
    out["fit_launches"] = {k: sum(w["fit_launches"].get(k, 0) for w in workers)
                           for k in fit_want}
    out["apply_launches"] = {k: sum(w["apply_launches"].get(k, 0) for w in workers)
                             for k in apply_want}
    log(f"  (a) one process, 8 shards: fit {out['one_process_fit_s']:.3f} s; two processes of "
        f"4 shards: {out['children_wall_s']:.1f} s from spawn to exit, fits "
        f"{[round(w['fit_s'], 3) for w in workers]} s (two ranks on one card take turns: no "
        f"evidence of scaling); launches in all {out['fit_launches']}, {out['apply_launches']}")
    return out


def _hold_gram_acc(cuda_ops, gen, rows, d1, k, dtype, label, device="cuda"):
    """gram_corr_sym_acc at a shape the fold gives it (a densified chunk in
    the fold's slab layout) against its plain version, 1e-4 of the sums'
    scale on the upper tiles and the correlation (phase 1's)."""
    dev = torch.device(device)
    F = torch.randn((rows, d1), generator=gen, device=dev)
    Fs = tma_slab(F) if dtype == torch.bfloat16 else f32_slab(F)
    del F
    R = torch.randn((rows, k), generator=gen, device=dev)
    G0 = torch.randn((d1, d1), generator=gen, device=dev)
    C0 = torch.randn((d1, k), generator=gen, device=dev)
    want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G0, C0, Fs, R)
    got_g, got_c = cuda_ops.gram_corr_sym_acc(G0, C0, Fs, R)
    tiles = torch.arange(d1, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    Ff = Fs.float()
    Rq = R.to(torch.bfloat16).float() if dtype == torch.bfloat16 else R
    g_scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
    c_scale = torch.addmm(C0.abs(), Ff.abs().T, Rq.abs())
    g_diff = (got_g - want_g).abs()
    g_rel = (g_diff / g_scale)[upper].max().item()
    c_diff = (got_c - want_c).abs()
    c_rel = (c_diff / c_scale).max().item()
    err = max(g_diff[upper].max().item(), c_diff.max().item())
    check(f"27 gram_corr_sym_acc {label} F {rows}x{d1}, R {rows}x{k} against its plain version",
          g_rel <= 1e-4 and c_rel <= 1e-4,
          f"max_abs_err {err:.3e} ({g_rel:.2e} / {c_rel:.2e} of scale, tol 1e-4)")
    return err


def phase_multi_scaling(cuda_ops, smi, device="cuda"):
    """27(b): tools.multichip --scaling on the card at phase 25(d)'s
    geometry: legs of 1, 2, 4 and 8 shards over cuda:0, each leg's
    gram_corr_sym_acc launches of one rep, its scaling line read back with
    device_evidence false (8 shards share one card)."""
    import contextlib
    import io

    from keystone_tpu_torch.tools import multichip

    gen = torch.Generator(device=device).manual_seed(27)
    d = int(MULTI_SCALING_ARGV[MULTI_SCALING_ARGV.index("--d") + 1])
    chunk = int(MULTI_SCALING_ARGV[MULTI_SCALING_ARGV.index("--chunk") + 1])
    k = 2
    err = _hold_gram_acc(cuda_ops, gen, chunk, d, k, torch.float32, "f32 (the scaling fold)",
                         device)
    torch.cuda.empty_cache()
    buf = io.StringIO()
    argv = MULTI_SCALING_ARGV + ["--device", str(torch.device(device))]
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = multichip.main(argv)
    seconds = time.perf_counter() - t0
    counts = _launches_since(cuda_ops)
    text = buf.getvalue()
    (line,) = [ln for ln in text.splitlines() if ln.startswith("scaling: ")]
    scaling = json.loads(line[len("scaling: "):])
    n = int(MULTI_SCALING_ARGV[MULTI_SCALING_ARGV.index("--n") + 1])
    seg = int(MULTI_SCALING_ARGV[MULTI_SCALING_ARGV.index("--seg") + 1])
    chunks = -(-n // chunk)
    want = {}
    for leg in scaling["legs"]:
        m = leg["num_devices"]
        cpd = -(-chunks // m)
        s = min(seg, cpd)
        want[m] = -(-chunks // seg) * seg if m == 1 else m * (-(-cpd // s) * s)
    got = {leg["num_devices"]: leg["launches"].get("gram_corr_sym_acc", 0)
           for leg in scaling["legs"]}
    log(f"  (b) tools.multichip {' '.join(argv)}: rc {rc}, {seconds:.1f} s; legs "
        + "; ".join(f"m={leg['num_devices']} wall {leg['wall_s']} s (fold {leg.get('fold_s')}, "
                    f"solve {leg.get('solve_s')}) parity {leg['parity_max_dw']:.3e} "
                    f"launches {leg['launches']}" for leg in scaling["legs"])
        + f"; device_evidence {scaling['device_evidence']} ({smi})")
    check("27(b) --scaling: parity over the legs, device_evidence false on one card",
          rc == 0 and scaling["device_evidence"] is False
          and [leg["num_devices"] for leg in scaling["legs"]] == [1, 2, 4, 8]
          and scaling["parity_worst_max_dw"] <= scaling["parity_tol"],
          f"rc {rc}, worst {scaling['parity_worst_max_dw']:.3e}")
    # Each leg runs a warm fit and --reps timed ones.
    reps = 1 + int(MULTI_SCALING_ARGV[MULTI_SCALING_ARGV.index("--reps") + 1])
    total = {"gram_corr_sym_acc": reps * sum(want.values())}
    check("27(b) gram_corr_sym_acc once a chunk id a fit in every leg",
          got == want and same_launches(counts, total),
          f"a rep a leg {got}, expected {want}; the run {counts}, expected {total}")
    return dict(rc=rc, seconds=seconds, scaling=scaling, launches_by_leg=got,
                launches=counts, check_max_abs_err=err)


def phase_multi_hybrid(cuda_ops, root, smi, device="cuda"):
    """27(c): run_lbfgs_gram_hybrid at the Amazon geometry, 27 of 64 chunks
    resident (int16 + bf16) and 37 streamed from disk shards in segments
    of 16, against run_lbfgs_gram_streamed over the same 64 resident
    chunks, bit for bit; gram_corr_sym_acc once a chunk in each fit."""
    from keystone_tpu_torch.data.prefetch import PrefetchStats
    from keystone_tpu_torch.data.resident import CompressedCOOChunks
    from keystone_tpu_torch.data.shards import DiskCOOShards
    from keystone_tpu_torch.ops.learning.lbfgs import (
        _resident_chunk_fn, run_lbfgs_gram_hybrid, run_lbfgs_gram_streamed)

    c, d, nnz, k = AMAZON_CHUNK, AMAZON_D, AMAZON_NNZ, AMAZON_K
    n = HYBRID_CHUNKS * c
    gen = torch.Generator(device=device).manual_seed(2727)
    dev = torch.device(device)
    out = {}
    err = _hold_gram_acc(cuda_ops, gen, c, d + 1, k, torch.bfloat16, "bf16 (the hybrid fold)",
                         device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    idx = torch.randint(0, d, (n, nnz), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.cat([idx.sort(dim=1).values, torch.full((n, 1), d, dtype=torch.int32,
                                                        device=dev)], dim=1)
    val = torch.randn((n, nnz), generator=gen, device=dev)
    val = torch.cat([val, torch.ones((n, 1), device=dev)], dim=1)
    Y = torch.randn((n, k), generator=gen, device=dev)
    every = CompressedCOOChunks.encode(idx, val, Y, chunk_rows=c, d=d + 1, n_true=n)
    del idx, val, Y
    resident = tuple(t[:HYBRID_RESIDENT].clone() for t in every.operands())
    out["resident_gb"] = sum(t.numel() * t.element_size() for t in resident) / 1e9
    tail = [t[HYBRID_RESIDENT:].cpu() for t in every.operands()]
    shards = DiskCOOShards.write(
        os.path.join(root, "hybrid"), tail[0].reshape(-1, nnz + 1).to(torch.int32).numpy(),
        tail[1].reshape(-1, nnz + 1).to(torch.float32).numpy(), tail[2].reshape(-1, k).numpy(),
        chunk_rows=c, n_true=(HYBRID_CHUNKS - HYBRID_RESIDENT) * c, d=d + 1)
    del tail
    out["setup_s"] = time.perf_counter() - t0
    kw = dict(lam=AMAZON_LAM, num_iterations=AMAZON_ITERS, n=n, val_dtype=torch.bfloat16)
    cuda_ops.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    W_s, loss_s = run_lbfgs_gram_streamed(_resident_chunk_fn, HYBRID_CHUNKS, d + 1, k,
                                          operands=every.operands(),
                                          max_chunks_per_dispatch=HYBRID_SEG, pipeline=False,
                                          **kw)
    _sync(device)
    out["streamed_s"] = time.perf_counter() - t0
    out["streamed_launches"] = _launches_since(cuda_ops)
    del every
    torch.cuda.empty_cache()
    stats = PrefetchStats()
    cuda_ops.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    W_h, loss_h = run_lbfgs_gram_hybrid(
        _resident_chunk_fn, HYBRID_RESIDENT, resident, HYBRID_CHUNKS, d + 1, k,
        max_chunks_per_dispatch=HYBRID_SEG, segment_source=shards.as_source(HYBRID_SEG),
        prefetch_stats=stats, device=device, **kw)
    _sync(device)
    out["hybrid_s"] = time.perf_counter() - t0
    out["hybrid_launches"] = _launches_since(cuda_ops)
    out["tail_segments"] = shards.as_source(HYBRID_SEG).num_segments
    out["check_max_abs_err"] = err
    log(f"  (c) hybrid: {HYBRID_RESIDENT} of {HYBRID_CHUNKS} chunks resident "
        f"({out['resident_gb']:.3f} GB), {HYBRID_CHUNKS - HYBRID_RESIDENT} from disk in "
        f"{out['tail_segments']} segments of {HYBRID_SEG}; set-up {out['setup_s']:.1f} s; "
        f"hybrid fit {out['hybrid_s']:.3f} s, launches {out['hybrid_launches']}; the streamed "
        f"fold over all {HYBRID_CHUNKS} resident chunks {out['streamed_s']:.3f} s, launches "
        f"{out['streamed_launches']}; loss {float(loss_h):.7f} ({smi})")
    check("27(c) the hybrid fold has the streamed fold's bits",
          torch.equal(W_h, W_s) and torch.equal(loss_h, loss_s) and bool(W_h.isfinite().all()),
          f"max |dW| {(W_h - W_s).abs().max().item():.3e}")
    want = {"gram_corr_sym_acc": HYBRID_CHUNKS}
    check("27(c) gram_corr_sym_acc once a chunk in each fit",
          same_launches(out["hybrid_launches"], want)
          and same_launches(out["streamed_launches"], want),
          f"{out['hybrid_launches']}, {out['streamed_launches']}, expected {want}")
    shutil.rmtree(os.path.join(root, "hybrid"), ignore_errors=True)
    return out


def phase_multi_cost(device="cuda"):
    """27(d): compiled_cost of a (m, k) x (k, n) product on the card reads
    2 m n k FLOPs and the operands' and output's bytes."""
    from keystone_tpu_torch.utils import profiling

    gen = torch.Generator(device=device).manual_seed(28)
    A = torch.randn((COST_M, COST_K), generator=gen, device=device)
    B = torch.randn((COST_K, COST_N), generator=gen, device=device)
    cost = profiling.compiled_cost(lambda x, y: x @ y, A, B)
    want = 2 * COST_M * COST_N * COST_K
    nbytes = 4 * (COST_M * COST_K + COST_K * COST_N + COST_M * COST_N)
    log(f"  (d) compiled_cost of a {COST_M}x{COST_K} @ {COST_K}x{COST_N} product on the card: "
        f"{cost}")
    check("27(d) compiled_cost counts 2mnk FLOPs and the product's bytes",
          cost is not None and cost["flops"] == want and cost["bytes accessed"] == nbytes,
          f"{cost}, expected flops {want}, bytes {nbytes}")
    return cost


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--phase27-worker"]:
        return phase27_worker(*sys.argv[2:])
    if sys.argv[1:] == ["--cifar-profile"]:
        return cifar_profile()
    if sys.argv[1:] == ["--first-verify"]:
        return first_verify()
    from keystone_tpu_torch.ops import cuda_images, cuda_ops
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.pipelines.timit import TimitConfig
    from keystone_tpu_torch.workflow import fusion

    script_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = cuda_ops.build()
    log(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in ptxas_lines(cuda_ops, report):
            log(f"  {name}: {line}")
    hgmma = sass_count(cuda_ops, "gram_corr_sym_acc", "HGMMA")
    if hgmma is None:
        log("  gram_corr_sym_acc: cuobjdump not found, SASS not read")
    else:
        check("gram_corr_sym_acc runs on the tensor cores", hgmma > 0,
              f"{hgmma} HGMMA instructions in its SASS (cuobjdump -sass)")

    phase_seconds = {}
    clock = [None, time.perf_counter()]

    def phase(label, title):
        """Log the phase's title; the previous phase's seconds go to
        ``phase_seconds``."""
        now = time.perf_counter()
        if clock[0] is not None:
            phase_seconds[clock[0]] = round(now - clock[1], 3)
            log(f"  phase {clock[0]}: {phase_seconds[clock[0]]:.1f} s")
        clock[:] = [label, now]
        if title:
            log(f"[phase {label}] {title}")

    phase("1", "kernels against their plain versions")
    cuda_ops.reset_launch_counts()
    results = phase_kernels(cuda_ops)
    gen = torch.Generator(device="cuda").manual_seed(1)
    results.update(phase_cifar_kernels(cuda_ops, cuda_images, fusion, gen))
    phase_new_forms(cuda_ops, cuda_images, fusion, gen, results)
    log(f"  phase 1 launches (checks and timing, not the main path): {cuda_ops.launches}")
    phase("2", "TIMIT slice: three routes small against the CPU; --solver block at full width")
    phase_small_reference(timit, TimitConfig)
    stacked_counts, stacked, stacked_model = phase_timit_route(cuda_ops, timit, TimitConfig,
                                                           fit_first=False)
    flat_counts, flat, _ = phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=True)
    phase("3", "README quick-start composition")
    phase_quickstart(cuda_ops)
    phase("4", "TIMIT --solver streaming at full width")
    streamed_counts, streamed = phase_streamed(cuda_ops, timit, TimitConfig)
    phase("5", "optimizer-bound streamed fit")
    phase_optimizer_bound(cuda_ops, timit, TimitConfig)
    phase("6", "RandomPatchCifarKernel: small against the CPU; full width")
    cifar_counts, cifar_run, cifar_result, cifar_config = phase_cifar(cuda_ops, fusion)
    phase("7", "where the full-width CIFAR fit's time goes")
    cifar_run["time"] = phase_cifar_time(cuda_ops, fusion, cifar_result, cifar_config)
    phase("8", "sparse ridge slice: small against the CPU; Amazon geometry by four engines")
    phase_sparse_small(cuda_ops)
    sparse_counts, sparse_run, amazon = phase_sparse(cuda_ops)
    phase("9", "sketched tier: small against the CPU; the frontier sweep at the Amazon "
          "geometry")
    phase_sketch_small(cuda_ops)
    sketch_counts, sketch_run = phase_sketch(cuda_ops, amazon)
    # Phase 21(c) holds the sparse disk fold to the bf16 gram engine's bits.
    amazon_gram_bf16, amazon_w_true = amazon["gram_bf16"], amazon["w_true"]
    control_refs = dict(amazon=amazon["by_engine"],
                        amazon_gather_scale=float(amazon["gather"].x.abs().max()))
    del amazon
    torch.cuda.empty_cache()
    phase("10", "the block update's sym=False route at TIMIT width")
    sym_counts, sym_run = phase_sym_false(cuda_ops)
    phase("11", "TIMIT --solver auto on both sides of the memory wall; the bf16 routes")
    auto_res, auto_wall, f32_model = phase_auto(cuda_ops, timit, TimitConfig, stacked_model[0])
    control_refs["timit_test_error"] = auto_res["test_error"]
    bf16_routes = phase_bf16_routes(cuda_ops, f32_model,
                                    auto_wall["solver_streaming_fit_seconds"])
    del f32_model
    phase("12", "TIMIT --solver auto at the reference's default width: the block-streamed "
          "tier")
    phase_block_small(cuda_ops)
    block_resident = phase_block_resident(cuda_ops, timit, TimitConfig, stacked_model)
    # Phase 25(a) holds the mesh fit to this one-device fit (9.6 MB).
    mesh_reference = stacked_model
    del stacked_model
    log(f"  (c) d={WIDE_D}, n={WIDE_N}")
    wide_auto = phase_wide_auto(cuda_ops, timit, TimitConfig)
    wide_auto["breakdown"] = phase_wide_breakdown(cuda_ops)
    log(f"  (d) past 2^31 elements: one f32 block slab of {BIG_N} x {BLOCK}")
    wide_auto["past_2_31"] = phase_past_2_31(cuda_ops)
    log(f"  (d) the north star's n: one f32 block slab of {NORTH_N} x {BLOCK}")
    wide_auto["north_star_f64"] = phase_north_star_f64(cuda_ops)
    phase("13", "MnistRandomFFT: small against the CPU; at its own width, apply first and "
          "fit first")
    mnist_run = phase_mnist(cuda_ops)
    phase("14", "AmazonReviewsPipeline: the L-BFGS small against the CPU; 200,000 documents")
    amazon_run = phase_amazon()
    phase("15", "VOCSIFTFisher: the image modules small against the CPU; d = 40,960 on "
          "5,011 + 4,952 images")
    phase_images_small()
    voc_run = phase_voc(cuda_ops)
    # The VOC shape's launches are those counted on phase 15's run.
    results["gram_corr_sym"]["voc_shape"]["launches"] = voc_run["launches"]["gram_corr_sym"]
    phase("16", "ImageNetSiftLcsFV: 1,000 classes, 16,000 + 5,000 images")
    imagenet_run = phase_imagenet(cuda_ops)
    phase("17", "the CLI's last six pipelines and Nystrom KRR at full width")
    log("  (b) the four CIFAR runners")
    runners = phase_cifar_runners(cuda_ops, fusion)
    log("  (c) Nystrom KRR on RandomPatchCifar's training features")
    nystrom = phase_nystrom(cuda_ops)
    log("  (d) NewsgroupsPipeline")
    news = phase_newsgroups(cuda_ops)
    log("  (e) StupidBackoffPipeline")
    backoff = phase_stupid_backoff()
    phase("18", "the workflow layer: plan verifier, auto-caching optimizer, datum programs")
    workflow = dict(verify=phase_verify(cuda_ops, timit))
    workflow["autocache"] = phase_autocache(cuda_ops)
    workflow["chain_plan"] = phase_chain_plan()
    workflow["datum"] = phase_datum(cuda_ops, timit)
    phase("19", "the serving path: bucketed CUDA-graph plans, micro-batcher, replicated "
          "plane, hot swap, open-loop latency")
    plan, scores, pool, offline, serve_plan = phase_serve_plan(cuda_ops, timit)
    serving = dict(plan=serve_plan, cli=phase_serve_cli(cuda_ops))
    swap_fits = [scores]
    serving["swap"] = phase_serve_swap(cuda_ops, timit, plan, pool, fits=swap_fits)
    # Phase 22's tenants are pickle clones of the two seeds' fits.
    zoo_blobs = [pickle.dumps(f) for f in swap_fits]
    del swap_fits
    serving["latency"] = phase_serve_latency(plan, scores, pool, smi)
    phase("20", "continuous learning: the row-stable product, the lifecycle gate, run.py "
          "learn, a killed trainer's resume")
    results["row_stable_matmul"] = phase_row_stable(cuda_ops)
    learn = dict(gate=phase_learn_gate(plan, serve_plan, serving["swap"]))
    cuda_ops.reset_launch_counts()
    learn["cli"] = phase_learn_cli()
    learn["timit"] = phase_learn_timit(timit, plan, pool)
    learn["resume"] = phase_learn_resume()
    learn_counts = dict(cuda_ops.launches)
    learn["launches"] = {k: v for k, v in learn_counts.items() if v}
    log(f"  phase 20 launches (c)-(e): {learn['launches']}")
    check("20 the learn path launched row_stable_matmul and cosine_features",
          learn_counts["row_stable_matmul"] > 0 and learn_counts["cosine_features"] > 0,
          f"{learn['launches']}")
    del plan, scores, pool, offline
    torch.cuda.empty_cache()
    phase("21", "the out-of-core data plane: TIMIT fitted from disk at n = 2,200,000, a killed "
          "disk fold resumed, the sparse disk tier, the CSV and image spill paths")
    disk_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             f"phase21-{os.getpid()}")
    os.makedirs(disk_root, exist_ok=True)
    try:
        disk = dict(timit=None)
        disk["timit"], disk_counts, sld, bank, model = phase_disk_timit(
            cuda_ops, timit, TimitConfig, disk_root, smi)
        disk["resume"] = phase_disk_resume(cuda_ops, sld, bank, model, disk_root, smi)
        del sld, bank, model
        torch.cuda.empty_cache()
        disk["sparse"], disk_sparse_counts = phase_disk_sparse(
            cuda_ops, amazon_w_true, amazon_gram_bf16, disk_root, smi)
        disk["spill"] = phase_disk_spill(disk_root, smi)
    finally:
        shutil.rmtree(disk_root, ignore_errors=True)
    torch.cuda.empty_cache()
    phase("22", "the model zoo and the autoscaler: paging TIMIT tenants under a device budget, "
          "isolation, cold start, run.py serve --tenants / --autoscale, the SLO loop")
    pool = serve_pool()
    zoo = dict(paging=phase_zoo_paging(cuda_ops, zoo_blobs, pool, smi))
    zoo["isolation"] = phase_zoo_isolation(zoo_blobs, pool)
    zoo["cold_start"] = phase_zoo_cold_start(zoo_blobs, pool)
    zoo["cli"] = phase_zoo_cli(cuda_ops)
    zoo["autoscale"] = phase_autoscale(zoo_blobs, pool, smi)
    phase("23", "the control plane: the cost-weight sweep, calibration and the H100 refit, the "
          "selector on the card, the live exporter, the capacity planner")
    control_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                f"phase23-{os.getpid()}")
    os.makedirs(control_root, exist_ok=True)
    cuda_ops.reset_launch_counts()
    try:
        control = dict(sweep=phase_control_sweep(cuda_ops, control_root))
        control["calibrate"] = phase_control_calibrate(control["sweep"], control_root)
        control["selector"] = phase_control_selector(cuda_ops, timit, TimitConfig,
                                                     control["sweep"], control["calibrate"],
                                                     control_refs, control_root)
        control["live"] = phase_control_live(cuda_ops, zoo_blobs[0], control_root)
        control["plan"] = phase_control_plan(cuda_ops, control["live"], control["selector"],
                                             control_root)
    finally:
        shutil.rmtree(control_root, ignore_errors=True)
    # The launches that held kernels to their plain versions are not the
    # control plane's.
    control_counts = {k: v - CONTROL_CHECK_LAUNCHES.get(k, 0)
                      for k, v in cuda_ops.launches.items()}
    control["launches"] = {k: v for k, v in control_counts.items() if v}
    control["check_launches"] = dict(CONTROL_CHECK_LAUNCHES)
    control["sweep"].pop("dir")
    log(f"  phase 23 launches: {control['launches']}, and {CONTROL_CHECK_LAUNCHES} holding "
        f"kernels to their plain versions ({smi})")
    phase("24", "the process fleet: TIMIT's plan on 2 plane processes, a SIGKILL under a "
          "200 Hz storm, run.py serve --fleet, the chaos tool, quarantine and a canary")
    torch.cuda.empty_cache()
    fleet, fleet_ship, fleet_run = phase_fleet_serve(zoo_blobs[0], pool)
    try:
        fleet_run["kill"] = phase_fleet_kill(fleet, pool, fleet_run.pop("footprint"))
        fleet_run["integrity"] = phase_fleet_integrity(fleet, zoo_blobs[1], fleet_ship, pool)
        fleet_run["chaos"] = phase_fleet_chaos(fleet, pool)
    finally:
        fleet.close()
    del fleet, fleet_ship
    fleet_run["cli"] = phase_fleet_cli(cuda_ops)
    log(f"  phase 24 launches in the planes of (a): {fleet_run['launches']} ({smi})")
    del pool
    torch.cuda.empty_cache()
    phase("25", "the one-host mesh: 8 shards on the card; TIMIT --solver block on sharded rows, "
          "the streamed and block-streamed mesh folds, tools.multichip")
    mesh_run = dict(shape_errors=phase_mesh_shapes(cuda_ops))
    mesh_run["timit"] = phase_mesh_timit(cuda_ops, timit, TimitConfig, mesh_reference, smi)
    del mesh_reference
    torch.cuda.empty_cache()
    mesh_run["streamed"] = phase_mesh_streamed(cuda_ops, timit, TimitConfig, smi)
    torch.cuda.empty_cache()
    mesh_run["block_streamed"] = phase_mesh_block_streamed(cuda_ops, timit, TimitConfig, smi)
    torch.cuda.empty_cache()
    mesh_run["multichip"] = phase_mesh_multichip(cuda_ops, smi)
    mesh_parts = {"a_fit": mesh_run["timit"]["fit_launches"],
                  "a_apply": mesh_run["timit"]["apply_launches"],
                  "b": mesh_run["streamed"]["launches"],
                  "c": mesh_run["block_streamed"]["launches"],
                  "d": mesh_run["multichip"]["launches"]}
    log(f"  phase 25 launches by part: {mesh_parts} ({smi})")
    torch.cuda.empty_cache()
    phase("26", "the ring tier: the mesh KRR sweep and ring apply at RandomPatchCifarKernel's "
          "KRR width on 8 shards, ring_pairwise_gaussian, ring_gram, ring_attention, "
          "profile=True, bf16x3; HOG, DAISY, RWLS and the streamed ZCA against the CPU")
    ring_run = dict(shapes=phase_ring_shapes(cuda_ops))
    ring_run["krr"] = phase_ring_krr(cuda_ops, smi)
    torch.cuda.empty_cache()
    ring_run["primitives"] = phase_ring_primitives(cuda_ops, smi)
    torch.cuda.empty_cache()
    ring_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             f"phase26-{os.getpid()}")
    os.makedirs(ring_root, exist_ok=True)
    try:
        ring_run["options"] = phase_ring_options(ring_root, smi)
    finally:
        shutil.rmtree(ring_root, ignore_errors=True)
    ring_parts = {"26a_fit": ring_run["krr"]["fit_launches"],
                  "26b_apply": ring_run["krr"]["apply_launches"],
                  "26c_pairwise": ring_run["primitives"]["pairwise_launches"]}
    log(f"  phase 26 launches by part: {ring_parts} ({smi})")
    mesh_parts.update(ring_parts)
    torch.cuda.empty_cache()
    phase("27", "the multi-process mesh: two processes of 4 shards on the card (gloo), the KRR "
          "sweep and ring apply bit for bit, the normal equations, the n-gram exchange; "
          "tools.multichip --scaling; the hybrid compressed fold; compiled_cost")
    multi_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              f"phase27-{os.getpid()}")
    os.makedirs(multi_root, exist_ok=True)
    try:
        multi_run = dict(krr=phase_multi_krr(cuda_ops, multi_root, smi))
        torch.cuda.empty_cache()
        multi_run["scaling"] = phase_multi_scaling(cuda_ops, smi)
        torch.cuda.empty_cache()
        multi_run["hybrid"] = phase_multi_hybrid(cuda_ops, multi_root, smi)
        torch.cuda.empty_cache()
        multi_run["cost"] = phase_multi_cost()
    finally:
        shutil.rmtree(multi_root, ignore_errors=True)
    multi_parts = {
        "27a_fit": multi_run["krr"]["fit_launches"],
        "27a_apply": multi_run["krr"]["apply_launches"],
        "27b_scaling": multi_run["scaling"]["launches"],
        "27c_hybrid": multi_run["hybrid"]["hybrid_launches"],
    }
    log(f"  phase 27 launches by part (27a summed over the two processes, 27b every leg's "
        f"warm and timed fits): {multi_parts} ({smi})")
    phase(None, None)
    # The new forms' launches are those counted on phase 17's routes.
    conv_shapes = results["conv_featurize"]["shapes"]
    conv_shapes["no whitener 32 x 32"]["launches"] = \
        runners["RandomCifar"]["launches"]["conv_featurize"]
    conv_shapes["whitened 24 x 24"]["launches"] = \
        runners["RandomPatchCifarAugmented"]["launches"]["conv_featurize"]
    for label, key in (("nystrom K(X, L)", f"{CIFAR_N}x{NYS_M}"),
                       ("nystrom K(L, L)", f"{NYS_M}x{NYS_M}")):
        results["gaussian_kernel_block"]["shapes"][label]["launches"] = sum(
            run["launches_by_shape"].get(key, 0) for run in nystrom.values())

    route_counts = {FLAT: flat_counts, STACKED: stacked_counts, STREAMED: streamed_counts,
                    CIFAR: cifar_counts, SPARSE: sparse_counts, SKETCH: sketch_counts,
                    SYM_FALSE: sym_counts, LEARN: learn_counts}
    kernels = [
        dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
             launches=route_counts[meta["path"]][name], path=meta["path"], **results[name])
        for name, meta in KERNELS.items()
    ]
    # The bf16 routes' launches (phase 11(c)).
    for entry in kernels:
        if entry["name"] == "gram_sym_acc":
            entry["bf16_launches"] = bf16_routes["streamed"]["launches"]["gram_sym_acc"]
        elif entry["name"] == "block_gram_sym":
            entry["bf16_launches"] = bf16_routes["flat"]["launches"]["block_gram_sym"]
    # The serving path's launches (phase 19(a)), beside the fit route's.
    (cosine,) = [k for k in kernels if k["name"] == "cosine_features"]
    cosine["serving_launches"] = serve_plan["launches"].get("cosine_features", 0)
    # The disk tier's launches (phase 21(a) at depth 2, 21(c) at depth 2).
    for entry in kernels:
        if entry["name"] in ("cosine_features", "gram_sym_acc"):
            entry["disk_launches"] = disk_counts[entry["name"]]
        elif entry["name"] == "gram_corr_sym_acc":
            entry["disk_launches"] = disk_sparse_counts[entry["name"]]
    # The zoo's launches (phase 22(a): replays and page-ins' rebuilt buckets).
    for entry in kernels:
        if entry["name"] in ("cosine_features", ROW_STABLE):
            entry["zoo_launches"] = zoo["paging"]["launches"][entry["name"]]
    # The control plane's launches (the whole of phase 23).
    for entry in kernels:
        entry["control_launches"] = control_counts[entry["name"]]
    # The fleet's launches (phase 24(a): counted in each plane process from
    # its spawn, summed over the planes).
    for entry in kernels:
        if entry["name"] in ("cosine_features", ROW_STABLE):
            entry["fleet_launches"] = fleet_run["fleet_launches"][entry["name"]]
    # The mesh path's launches (phase 25: each kernel once a shard), by part.
    for entry in kernels:
        by_part = {part: c[entry["name"]] for part, c in mesh_parts.items()
                   if c.get(entry["name"])}
        entry["mesh_launches"] = sum(by_part.values())
        entry["mesh_launches_by_part"] = by_part
        if entry["name"] in mesh_run["shape_errors"]:
            entry["mesh_shape_max_abs_err"] = mesh_run["shape_errors"][entry["name"]]
        # The ring tier's shard shapes (phase 26): times beside the bound.
        if entry["name"] in ring_run["shapes"]:
            entry["ring_shapes"] = ring_run["shapes"][entry["name"]]
        # Phase 27's launches: the two processes' KRR fit and ring apply,
        # the scaling legs and the hybrid fold.
        by_part = {part: c[entry["name"]] for part, c in multi_parts.items()
                   if c.get(entry["name"])}
        entry["multiprocess_launches"] = sum(by_part.values())
        entry["multiprocess_launches_by_part"] = by_part
    main_path = {FLAT: flat, STACKED: stacked, STREAMED: streamed, CIFAR: cifar_run,
                 SPARSE: sparse_run, SKETCH: sketch_run, SYM_FALSE: sym_run,
                 AUTO_RESIDENT: auto_res, AUTO_WALL: auto_wall, BF16_ROUTES: bf16_routes,
                 BLOCK_RESIDENT: block_resident,
                 WIDE_AUTO: wide_auto, "mnist MnistRandomFFT": mnist_run, AMAZON_TEXT: amazon_run,
                 VOC: voc_run, IMAGENET: imagenet_run, "cifar runners (apply first)": runners,
                 "nystrom KRR": nystrom, "newsgroups NewsgroupsPipeline": news,
                 "stupid backoff StupidBackoffPipeline": backoff, WORKFLOW: workflow,
                 SERVING: serving, LEARN: learn, DISK: disk, ZOO: zoo, CONTROL: control,
                 FLEET: fleet_run, MESH: mesh_run, RING: ring_run, MULTI: multi_run,
                 "phase_seconds": phase_seconds}
    log(f"main path: {json.dumps(main_path)}")
    log(f"whole script: {time.perf_counter() - script_start:.1f} s (build included)")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
