"""Smoke run of nums_tpu_torch on one CUDA card.

    python3 chip_smoke.py                 # phases 1-21
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check
    python3 chip_smoke.py --random-only   # phases 1 and 11
    python3 chip_smoke.py --facade-only   # phases 1, 2, 12 and 13
    python3 chip_smoke.py --models-only   # phases 1, 2 and 14
    python3 chip_smoke.py --mesh-only     # phases 1, 2, 15 and 16 on every card
    python3 chip_smoke.py --masks-only    # phases 1, 2 and 17 on every card
    python3 chip_smoke.py --mesh-core-only  # phases 1, 2 and 18 on every card
    python3 chip_smoke.py --shape-only    # phases 1, 2 and 19 on every card
    python3 chip_smoke.py --mesh-random-only  # phases 1, 2 and 20 on every card
    python3 chip_smoke.py --mesh-signal-only  # phases 1, 2 and 21 on every card

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from nums_tpu_torch/csrc, timed; the gram
     kernel's SASS (cuobjdump) must hold tensor-core HGMMA instructions,
     and the Newton passes' SASS 128-bit global loads (LDG.E.128); the two
     host libraries of the I/O layer (csrc/csv_parser.cpp, shard_io.cpp),
     timed, and the run fails if either did not build;
  3. each kernel against its plain torch version on the card, at small
     ragged shapes (d = 1, 28, 29, 97, 129, 1001, 1025; n not a multiple of any
     tile, and n < 64), in every rounding mode of the gram; the staged
     bf16 copy exactly as the plain rounding with a zero pad; the Newton
     statistics on X and on X staged once, and their two passes
     (newton_eta, newton_grad_scale) apart, the scaled operand exactly
     as the plain rounding with a zero pad; two calls of each kernel
     bitwise equal;
  4. the main path at full size through the public entry points:
     init() -> random_state -> X.T @ X -> LogisticRegression(newton).fit
     -> predict, checked against float64 and plain-float32 references,
     with launch counts showing that it ran through the kernels (X staged
     once for the fit, the statistics once per iteration), and its peak
     device memory. X, beta and u are drawn on threefry2x32 counters
     (``core/ops/threefry.py``): for this seed X is the array the
     reference draws, held at 16 positions to known answers computed
     with jax, and to its moments; the 2.5M x 1000 draw is timed beside
     one ``Tensor.normal_`` of a torch generator (the library call, used
     nowhere in the port) and its bound, and its peak device memory may
     exceed the output by at most 2 GB;
  5. times on the card (CUDA events, median of 5 after warm-up), each
     kernel against its plain version at the main path's shapes (K3 in
     each of its logistic, linear and Poisson kinds, on X staged once and
     on X, and its parts, each part also held to its plain version as in
     phase 3), the gram's staging pass alone, and the cuBLAS call that
     computes K1's and K2's function;
  6. profile: torch.profiler over one 10-iteration fit, device time by
     kernel (the full table goes to standard error), with the fit's
     launch counts and one staging pass;
  7. glm_families: the other GLM families and solvers on phase 4's X,
     each fit timed on the host clock and held to its check (the table
     in ``phase_glm_families``), with the launch counts of each fit
     (counts set to 0 just before it, read just after) and the peak
     device memory;
  8. ooc: phase 4's X and y written to disk (``DiskArray.from_panels``,
     10 panels of 250,000 rows, under ``settings.data_dir``, which must
     have 25 GB free; removed at the end) and streamed back panel by
     panel: ``gram_ooc`` (K1 per panel) against a float64 gram and the
     in-core gram, the logistic fit on the DiskArray (K3 one-shot per
     panel per iteration) against phase 4's in-core fit, one statistics
     pass with the Newton gate off (K2 per panel) against the same pass
     on K3, ``linear_regression_ooc`` (K1) against a float64 solve,
     ``predict_ooc`` against the in-core labels, and save/load bit for
     bit; exact launch counts per step, the peak device memory of the
     streamed steps (at most 8 panels above what was allocated before
     them), the time of each step, one pass split into disk, host to
     device and device, and K1, K2 and K3 at the panel shape, each held
     to its plain version; and PCA and TruncatedSVD (16 components) fitted
     on the DiskArray (K1 per panel, the moments of one streamed pass) and
     its ``transform`` to a new DiskArray, held to a float64 covariance,
     to the same fits with the gram gate off and to the in-core
     ``transform`` of the first and last panel; KMeans(16) on the
     DiskArray (two passes at tol 0, the final inertia pass, no kernel)
     within 1e-4 of in-core Lloyd's from the same first-panel seeding, and
     its ``predict_ooc`` labels equal to the in-core ``predict``;
  9. linalg: on phase 4's X, its columns scaled to a decaying spectrum,
     ``randomized_svd`` and the randomized PCA; then, X freed, the linalg
     entry points on A = N(0,1) at 2^24 x 128 fp32 (8.6 GB) with a planted
     least-squares problem: ``indirect_tsr``, ``indirect_tsqr``,
     ``direct_tsqr`` (also with ``overwrite_x=True``), ``svd``, the three
     regressions (``ridge_regression``'s ``R.T @ R`` on K1), an in-core PCA
     and a StandardScaler round trip under ``tsqr_method="auto"``
     (CholeskyQR2 on the card), and ``indirect_tsr`` and ``direct_tsqr``
     under ``"householder"``; each held to float64 references (the table
     in ``phase_linalg``) and timed on the host clock beside its bound
     and its peak device memory; K1 on ``ridge_regression``'s own R
     against its plain version; device time by kernel of the two forms
     of CholeskyQR2;
 10. higgs: the HIGGS pipeline at 11,000,000 x 29 (a label and 28
     features) from text: a CSV written from a seed under
     ``settings.data_dir`` (3.8 GB; 8 GB must be free; removed at the end),
     ``read_csv_host`` in 16 byte ranges through the native parser (the
     ingested X and y bitwise equal to the float32 arrays that made the
     file; the first and last range bitwise equal to ``np.loadtxt``), host
     to device, the 80/20 split, ``X_train.T @ X_train`` (K1),
     ``LogisticRegression(newton).fit`` (K3, X staged once) and ``predict``
     twice, with exact launch counts, the gram held to a float64 gram, the
     accuracy to the planted beta's and beta to the plain-fp32 refit; K1,
     K2 and K3 at 8.8M x 28/29 against their plain versions; X_test through
     ``write_fs``/``read_fs`` with the native block engine and with
     ``np.save``/``np.load`` (byte-equal files), and through the ``s3://``
     verbs on the file-backed fake;
 11. random: the Random123 vectors on the card; known answers from the
     reference (bits, ``random``, ``normal``, ``integers(0, 1000)`` at 16
     flat positions of a 2.5M x 1000 draw and 4 beyond 2^32 of a virtual
     10M x 1000 one, ``permutation(1000)`` whole; ``RANDOM_KNOWN``); the
     card against the package's own CPU route on a 2^22-position slice
     (bits, ``random``, ``integers``, ``permutation(2.5M)`` equal,
     ``normal`` within 4 ulp) and every other distribution at 2^20 draws
     within its class's tolerance (the table in ``phase_random``); chunk
     size and block shape independence, bitwise; ``permutation(2.5M)`` a
     permutation in two rounds of sort; one draw of each distribution at
     2^22 against its law; ``get_state``/``set_state`` resuming a stream
     bitwise; a shuffled ``train_test_split`` of 2.5M rows partitioning
     them.
 12. facade: ``nums_tpu_torch.numpy`` on phase 4's X, drawn again from
     its seed: every contraction form of ``X.T @ X`` (the operator,
     ``nps.matmul``, ``nps.dot``, ``nps.tensordot(axes=1)``, ``X.T.dot``,
     ``nps.linalg.matmul``, ``multi_dot``, ``nps.transpose``) launching K1
     once each, bitwise equal to each other and within 2e-3 of a float64
     gram, and none under ``"highest"``; ``X[y > 0]`` with planted labels
     (exact row count, bitwise ``X[idx]`` from the host); ``X[::-3]``,
     ``X[:, [3, 1, 4]]``, 2^20 points and ``X[..., None]``, bitwise
     numpy's on a host copy of a row slice; on a copy, ``Xc[Xc > 3] =
     3.0`` bitwise ``nps.clip(X, None, 3.0)`` with its peak at most the
     mask and one copy above X and ``Xc``, a packed write through a
     2.5e9-element mask and a slice write, X untouched; column
     ``sum``/``mean``/``var``/``std`` within 1e-5 of float64 and
     ``min``/``max``/``argmax`` equal; on 8 columns (20M values) ``sort``
     and stable ``argsort`` with ties, ``unique``, ``bincount`` and
     ``searchsorted`` equal to numpy's, ``median`` and ``percentile`` to 1
     ulp, ``histogram(64)`` counts equal on its edges, ``cumsum`` within
     1e-3 of float64; every ufunc of ``numpy/api.py`` at 2^20 in float32
     and int32 against the package's CPU route (``FACADE_EXACT`` and
     integers equal, the rest within 4 ulp); ``numpy.linalg``'s ``qr``/
     ``svd``/``lstsq``/``norm`` at 2^20 x 128 bitwise the application's,
     ``det``/``inv``/``solve``/``eigh``/``eig`` at 1000 x 1000 against
     float64 numpy. Each step's host-clock seconds after a synchronize,
     its bound and its peak device memory are in the phase's line.
 13. facade_tail: the facade's later modules on phase 12's X, with no
     kernel launched: ``fft.rfft`` of every row and ``irfft`` back within
     1e-5 of max|X|; ``fft`` of 8 columns (length 2.5M) within 1e-5 of
     numpy's float64 FFT, ``fftshift`` and ``fftfreq(2.5M)`` equal to
     numpy's; ``argpartition``/``partition(X, 10, axis=1)`` equal to the
     package's CPU route on 30,000 host rows, their 11 smallest numpy's;
     ``take_along_axis(argsort)`` bitwise ``sort``; ``lexsort`` of three
     columns, ``isin``/``in1d``, the four set operations and the four
     ``unique_*`` of 20M int32 values, ``histogram2d``/``histogramdd``
     counts on their edges, all equal to numpy's; ``nanquantile``/
     ``nanpercentile`` with 1% NaN to 1 ulp of float64 numpy; ``polyval``
     and a degree-3 ``polyfit`` on 2.5M points against float64; on a
     copy, ``putmask`` bitwise ``clip``, then ``put_along_axis``,
     ``fill_diagonal`` and ``copyto`` exact, X untouched; ``packbits``/
     ``unpackbits`` bitwise, ``bitwise_count``; ``frexp``, ``modf``,
     ``i0``, ``sort_complex`` and every float-to-integer cast at 2^20 on
     the card against the CPU route (equal, else within 4 ulp); ``roots``
     of degree 20, ``apply_along_axis`` on 100,000 rows, ``select`` and
     ``piecewise`` on X; ``nancumsum`` timed; the coverage report.
 14. models: (a) ``GBTClassifier(n_estimators=20, max_depth=4, n_bins=64,
     learning_rate=0.3)`` on scripts/benchmark_models.py's 1,000,000 x 28
     data, a cold and a warm fit (bitwise equal), train accuracy above
     0.8, ``predict`` equal to a numpy evaluation of the decision tables,
     the card against the CPU route on the first 100,000 rows (the same
     edges and splits, leaf values within 1e-5), a 3-class one-vs-rest
     fit on the score's terciles (``predict_proba`` rows sum to 1 within
     1e-6); (d) on phase 4's X and labels, the mean logistic loss in
     ``nps`` ops: ``value_and_grad`` and ``hvp`` within 1e-4 of float64,
     the gradient of sum(W ∘ XᵀX) through K1 (one launch) within 1e-5 of
     float64 X(W+Wᵀ) on 4096 rows, 100 adam steps of ``minimize`` eager
     and fused (the same n_iter, x within 1e-6, the loss falls), a host
     sync inside the function raising; (b) ``KMeans(16)`` on X plus 16
     planted centers (added in place): the first k-means++ row the
     reference's (a known answer computed with jax), the planted partition
     recovered exactly, centers and inertia within 1e-5 of float64 Lloyd's
     on the final assignment, two fits bitwise equal, one Lloyd iteration
     timed; one GBDT fit and one KMeans fit under torch.profiler (device
     time by kernel, idle share). Each step's host-clock seconds after a
     synchronize, its bound, its peak device memory and its launches are
     in the phase's line; no kernel but that one K1 launch; the phase
     within 90 s.
 15. mesh: the mesh backend (``MeshBackend``: one process per card under
     torch.distributed, arrays as DTensors). In the full run, on this card
     alone: a world-1 NCCL group (a file:// rendezvous under a temporary
     directory), phase 4's X drawn again on the mesh (its known answers,
     and its bits' checksum phase 4's), ``X.T @ X`` under ``auto``
     (``LAST_DISPATCH`` "xla", as the reference's on one device) and the
     fused fit on ``draw_labels``' labels: G, beta and the accuracy bit
     for bit phase 4's, K1 once, the statistics ten times and one stage;
     the all-reduce of H timed. With ``--mesh-only``, one process per
     visible card (``spawn``, NCCL), each on its own card, its output in
     ``mesh_logs/mesh_rank<r>.log``, at 10,000,000 x 1000 fp32 on the
     (cards, 1) mesh: the draw (each shard's first rows a serial draw of
     their positions, the known answers where a shard holds them), ``X.T
     @ X`` under the default route (K1 + all-reduce) and ``auto`` (K1 +
     reduce-scatter, "tn"), each within 1e-4 of a float64 gram (of
     max|G|, the diagonal) and its off-diagonal entries within 1e-2 of
     their own max, and the two routes within 1e-5 of each other; ``X @
     Xs.T`` ("nt", Xs 1024 rows) and ``X @ W`` under ``ring`` (W 1000 x
     1000 row-sharded; "xla" under auto, as in the reference) within 1e-5 of float64 products of each rank's
     rows; the fused logistic fit (K3 ten times and one stage a card,
     beta within 1e-2 of a float64 Newton fit, the accuracy within 0.01 of
     the planted beta's); then on a (2, cards/2) mesh X drawn as (5M,
     500) blocks (one range of positions per row; the first 64 rows of
     each the serial draw's) and ``X @ W`` under ``summa`` within 1e-5 of
     float64. Each
     step's time (CUDA events after a barrier, the slowest rank's), the
     all-reduce of g and H alone, each card's peak memory and each card's
     name and power limit; the run fails unless every rank exits 0 within
     840 s (and phase 16's own deadline).
 16. mesh_ooc: out of core on the mesh, each step a JSON line's entry with
     its seconds (host clock after a barrier, the slowest rank's), each
     card's launches of K1/K2/K3 (set to 0 just before it, read just
     after), bytes read through ``PanelRef.load`` and peak above what was
     allocated before it. In the full run on the world-1 mesh of phase 15,
     X of 1,000,000 x 1000 fp32 (phase 4's first rows) in 4 panels, under
     ``settings.data_dir`` (14 GB free needed, removed at the end); with
     ``--mesh-only`` on phase 15's X (its 2.5M rows a card the panels,
     each rank reading its quarter of each), after the I/O at realistic
     size: a 2.5M x 1000 slice (10 GB) written with two replicas, rank 0's
     block corrupted by the last rank and read through the failover, the
     collective ``verify_fs(repair=True)`` (one report on every rank) and
     ``delete_fs``, the slice through ``s3://`` on the file-backed fake,
     phase 10's HIGGS text (11M x 29) through ``read_csv`` (each rank
     parsing its rows) and, where pyarrow is installed, ``read_parquet``,
     both bitwise. The steps: ``write_fs`` (each rank its own block
     files), ``read_fs`` bitwise, the collective ``verify_fs`` and
     ``delete_fs``; ``spill`` of X and y; ``gram_ooc`` (K1 once a panel)
     within 1e-3 of the in-core gram; the logistic fit on the DiskArray
     (K3 one-shot a panel and pass, the in-core fit's iteration count, beta
     within 1e-2 of the in-core fit's); one statistics pass with the
     Newton gate off (K2) against K3's (g 1e-3, H 4e-3);
     ``linear_regression_ooc`` within 1e-2 of float64 normal equations;
     ``tsqr_r_ooc``, RᵀR within 1e-4 of the float64 gram;
     ``predict_ooc`` against the in-core ``predict`` (at most 1e-4 of the
     rows differ); PCA(16)'s fit (K1 once a panel; variances within 2e-3
     of float64, components orthonormal) and transform (within 1e-4 of a
     float64 projection); KMeans(16), two passes at tol 0 and
     ``predict_ooc``, held on one card to in-core Lloyd's and with
     ``--mesh-only`` by the parent to the same fit on a world-1 mesh of the
     first card (centers within 1e-4); then one pass taken apart on each
     rank (host read, host to device, K3, the all-reduce) and K1, K2 and
     K3 on a rank's rows of one panel against their plain versions. The
     phase fails past 900 s on any rank.
 17. masks: filter, encode and fit through the mesh's data-dependent ops
     (``core/ops/mesh_ops.py``). X's rows filtered twice, evenly
     (``X[X[:, 0] > 0]``, half the rows of every card) and skewed (``X[t >=
     0.7 N]`` for t = arange(N): the last 30% of the rows, on the last
     cards, re-placed to an even share of each card); then ``unique`` (with
     counts and inverse) of c = floor(U(0, 1000)) as int64, ``isin`` of c
     in 50 categories, ``digitize`` of a column at 32 quantile edges and
     ``bincount`` of its bins, ``histogram`` of a column in 64 bins, and
     ``where`` of the even mask; then ``Xs.T @ Xs`` (K1), the fused
     logistic fit on the skewed rows (K3) and ``predict``. Each step's
     seconds and the bytes each rank sent (with ``--masks-only`` the
     filters, K1 and the fit also timed warm by CUDA events, the slowest
     rank's). In the full run on phase 15's
     world-1 mesh and its X (2.5M x 1000), every result bit for bit the
     serial backend's on the same tensors, K1 once and K3 ten times in
     each. With ``--masks-only``, one process per card at 10,000,000 x
     1000 fp32 on the (cards, 1) mesh: every integer output equal to
     numpy's on the columns gathered to the host; each rank's filtered rows
     X's rows at the positions it holds (float64 row sums equal exactly,
     64 rows bit for bit the serial draw of their positions); G within
     1e-4 and beta within 1e-2 of float64 on each rank's rows, predict
     within 1e-4 of the rows' own labels; K1 once and K3 ten times a card;
     each card's peak below X's bytes (no card holds X whole);
     every rank exits 0 within 600 s.
 18. mesh_core: the in-core mesh path (``core/ops/mesh_linalg.py`` and
     the mesh branches of the models and the facade). The models: KMeans(16)
     (labels and inertia against float64 argmins of its centers), PCA(16)
     (singular values against the float64 centered gram's), lbfgs,
     logistic ADMM (l1) and Lasso on X's first 100 columns, each against
     the serial fit of the same rows on one card, the GBT on
     benchmark_models.py's data split over the ranks (accuracy, numpy
     tables); the facade: quantiles of 8 columns (numpy), ``cumsum`` of a
     long vector (float64), ``correlate``/``convolve`` by 1001 taps in three
     modes (float64 on each rank's interior, the sum identity), ``repeat``
     and ``pad`` of X (bitwise); device index arrays drawn by the sharded
     ``integers`` (X[idx] and X[idx] = 2·X[idx] by float64 row sums, a mask
     beside a device index); ``ridge_regression`` of X in column blocks
     (RᵀR sharded, K1 in it; θ against float64), ``cholesky``,
     ``posdef_solve`` and ``inv`` of a sharded SPD matrix by residuals on
     the mesh and at n = 1000 against float64 on the host; ``integers``
     and ``gamma`` at draw size (each shard's first rows a serial draw's).
     Each step's seconds, bytes sent and launches; warm times by CUDA
     events. In the full run on phase 15's world-1 mesh at 2.5M x 1000
     and n = 4096 (KMeans and the GBT also bit for bit the serial fits);
     with ``--mesh-core-only`` one process per card at 10M x 1000 and n =
     16384, each card's peak below X's bytes, every rank exits 0 within
     900 s.
 19. shape: the mesh's slicing, shape and order ops, none of which copies
     a sharded operand whole (``core/ops/mesh_ops.py``): ``X[n/10:9n/10]``,
     ``X[::2]``, ``X[::-1]``, ``X[n/2]``, ``split(X, 4)[2]``,
     ``X.reshape(2n, d/2)``, ``ravel``, ``concatenate([X, X])``,
     ``flip(X, 0)``, ``roll(X, 1234567, 0)``, ``diff``/``gradient`` along
     the rows, ``tril``, ``rfft(X[:, :64], axis=0)``, ``cov(X,
     rowvar=False)``, ``sort(X, axis=0)``, ``sort(X[:, :250], axis=None)``,
     ``kron(X[:, :8], ones((2, 1)))``, ``resize(X[:, :8], (2n, 8))``; then
     on a vector v of float32 normals and k of int32 integers, sharded:
     ``sort(v)``, ``argsort(v)``, ``partition(v, n/2)``,
     ``argpartition(v, n/4)``, ``lexsort((k, v))``, ``vander(v, 3)``,
     ``polyval(p, v)``. The moves bit for bit by an exact hash of bits at
     their places (each rank hashing its own rows at their new places, one
     all-reduce); ``tril`` and ``vander`` bit for bit against each rank's
     own part; the sorts' order within and across the ranks, their values
     a permutation of the operand's (key moments), the positions a
     permutation whose values are the sorted ones (pulled), the order
     statistics bit for bit ``select_ranks``'; diff, gradient (rows at
     and beside each box edge), rfft (three frequencies), cov and polyval
     within 1e-5 of float64 (cov 1e-3: cuBLAS's fp32 sums of 2.5M rows a
     card). Each step's seconds cold and warm (host clock after a
     barrier, the slowest rank's), and of the warm call its bytes sent
     (held to the slab it moves), the collectives ``CommDebugMode`` saw
     (no all-gather inside a torch op), its launches (K1/K2/K3 none) and
     peak (below X's bytes on four cards). In the full run on phase 15's world-1 mesh at 200,000 rows
     and a vector of 1e7, every result bit for bit the serial backend's;
     with ``--shape-only`` one process per card at 10M x 1000 and a
     vector of 2.5e9, every rank exits 0 within 900 s.
 20. mesh_random: the random layer on the mesh, each process drawing its
     own positions (``core/ops/random_ops.py``), and the linear algebra
     that copied a sharded operand whole: ``poisson(30)`` (Hörmann's
     rejection, one flag all-reduced a round), ``poisson(3)`` (Knuth's),
     ``binomial(100, 0.3)`` (BTRS) at 10M x 1000 float32;
     ``negative_binomial(5, 0.5)``, ``noncentral_chisquare(0.5, 2)``,
     ``noncentral_f(3, 5, 2)``, ``hypergeometric(50, 50, 20)`` at 10M x
     100; ``multivariate_normal`` of 10M rows x 64; ``multinomial(20, 16
     categories)`` of 10M rows; ``permutation(2.5e9)`` by the mesh's
     sample sort; ``shuffle(X)``; ``choice(X, 5M)`` with and without
     replacement; ``choice(10M, 5M, p)``; ``linalg.pinv(X)`` by TSQR;
     ``inner`` and ``cov(rowvar=True)`` of X's first 100,000 rows by
     summa's ring (a 100k x 100k result); ``diag`` and ``diagflat`` of a
     sharded 100k vector. Each draw held to its law (moments, range,
     integer values), the rejection samplers' round count by a 1M x 100
     draw bit for bit rank 0's serial draw (an exact hash), the
     permutation by a distributed count of each value, shuffle by an
     exact hash of X's rows at the places of the same-seed permutation,
     the choices' rows at their drawn positions bit for bit, pinv by
     ‖A·pinv(A)·A − A‖/‖A‖ and ‖pinv(A)·A − I‖ in float64, sampled rows
     of inner and cov against float64, diag and diagflat exactly. Each
     step's seconds (host clock after a barrier, the slowest rank's),
     bytes sent (held to a bound derived from its moves), collectives,
     launches (K1/K2/K3 none) and peak (below X's bytes on four cards).
     In the full run on phase 15's world-1 mesh at 100,000 rows, every
     result bit for bit the serial backend's; with ``--mesh-random-only``
     one process per card at 10M x 1000, every rank exits 0 within
     900 s.
 21. mesh_signal: the signal ops on the mesh through ``nps``: ``fft``,
     ``fftshift`` and ``ifft`` of a complex64 vector of 2.5e9 = 2^8·5^10
     (the four-step over 50,000 x 50,000), ``rfft``/``irfft`` of a float32
     vector of 2.5e9, ``fft`` at the prime 999,999,937 (Bluestein over
     2^31), each held to Parseval's identity in float64, 64 bins against
     a direct float64 DFT (within 5·2^-24·log2(n) of ‖x‖₂; three times
     that of 2^31 for Bluestein), its planted tones, the round trips and
     the shift's positions bit for bit; ``quantile``/``nanquantile`` of
     the float32 vector at a sharded q of 10^6 (NaNs planted for the
     second), 64 results bracketed by all-reduced counts; ``convolve``
     and ``correlate`` of a float32 signal of 1e8 by a sharded kernel of
     2^18 taps, ``polymul`` of two sharded polynomials of 2^20, each
     against float64 (4·2^-24·√taps of the largest output); ``poly`` of
     2^16 sharded roots in ±2^-16 at 16 points of the unit circle against
     the float64 product; ``fft2`` of X at 10M x 1000 (Parseval, 8 bins).
     Each step's seconds, bytes sent (held to a bound derived from its
     moves), collectives (no all-gather inside a torch op), launches
     (K1/K2/K3 none) and peak (below X's bytes on four cards). In the
     full run on phase 15's world-1 mesh at ``SIG_WORLD1``, every result
     bit for bit the serial backend's; with ``--mesh-signal-only`` one
     process per card, every rank exits 0 within 1000 s.
Then the kernels as one JSON line (each with its bound, the least time
the card could take for its work at this run's shapes), and last
{"ok": true, "device": {...}}. A failed phase prints its traceback and
exits with 1, without that last line. No CUDA device: exits with 2.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

N_FULL, D_FULL = 2_500_000, 1000
DEVICE = "cuda"
# Kernel vs its plain version on identical inputs: the bf16 rounding is
# the same, only the order of the f32 sums differs. Relative to max|plain|.
SMALL_REL = 1e-5       # phase 3, sums of at most a few thousand rows
FULL_REL = 1e-3        # phase 5, f32 sums of 2.5M rows: the plain cuBLAS
                       # product alone is 1.3e-4 off the kernel there, and
                       # phase 5 reports each side against a float64 sum
BF16_REL = 2e-3        # gram vs a float64 gram (tests/core/ops/test_pallas_gram.py:11)
BETA_REL = 1e-2        # bf16-class fit vs plain-float32 fit, max|Δβ| / max|β|:
                       # eta uses bf16(β), which pins β only to about one
                       # bf16 ulp (2^-8 = 3.9e-3 relative)
ACC_SLACK = 0.01       # fitted accuracy vs the true β's accuracy
FIT = dict(solver="newton", tol=1e-8, max_iter=10)
# One H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12      # outside the tensor cores


# The 2.5M x 1000 draw of phase 4: its peak device memory above the
# output, and its moments.
DRAW_SCRATCH_BYTES = 2e9
X_MEAN_ABS = 1e-4
X_VAR_ABS = 1e-3
NORMAL_KNOWN_REL, NORMAL_KNOWN_ABS = 2e-6, 1e-6

# What the reference draws in its accelerator mode (jax, 64-bit types off)
# under fold_in(key(seed), counter): raw 32-bit draws, ``random``,
# ``normal`` and ``integers(0, 1000)`` at flat positions of a 2.5M x 1000
# float32 / int32 draw ("positions": first, last, around a chunk edge of
# 2^25 and around 2^31) and of a virtual 10M x 1000 one
# ("positions_beyond_2_32", listed after the others in each value list),
# and ``permutation(1000)`` whole. Seed and counter are phase 4's X.
# tests/test_torch_random.py recomputes them with jax and asserts that they
# are equal.
RANDOM_KNOWN = {
    "seed": 1337,
    "counter": 1,
    "positions": [0, 1, 999, 1000, 33554431, 33554432, 33554433, 1234567890,
        2000000000, 2147483647, 2147483648, 2147483649, 1241513983,
        1241513984, 2499999998, 2499999999],
    "positions_beyond_2_32": [4294967296, 4294967297, 8589946937,
        9999999999],
    "bits": [1764235418, 1822911928, 4072251225, 2341061538, 3759282943,
        2460913530, 3937008107, 1141846338, 256644132, 1725033432,
        3938423956, 3454980516, 1073797586, 330244646, 2719107836,
        2006536914, 3514514198, 383144868, 3775882405, 3408187729],
    "random": [0.4107680320739746, 0.42442965507507324, 0.948144793510437,
        0.5450707674026489, 0.8752762079238892, 0.5729759931564331,
        0.9166560173034668, 0.2658567428588867, 0.05975461006164551,
        0.40164053440093994, 0.9169857501983643, 0.8044252395629883,
        0.2500128746032715, 0.07689106464385986, 0.6330915689468384,
        0.4671832323074341, 0.8182865381240845, 0.08920776844024658,
        0.879141092300415, 0.7935304641723633],
    "normal": [-0.2255696803331375, -0.19057399034500122,
        1.6271257400512695, 0.11321713775396347, 1.1516923904418945,
        0.18395601212978363, 1.382925033569336, -0.6253924369812012,
        -1.5568366050720215, -0.24910297989845276, 1.38507878780365,
        0.8575345873832703, -0.6744491457939148, -1.42629873752594,
        0.3400528132915497, -0.08235234022140503, 0.908854603767395,
        -1.3456496000289917, 1.1707040071487427, 0.818732500076294],
    "integers": [81, 4, 106, 177, 827, 554, 947, 599, 425, 10, 327, 908,
        765, 934, 68, 205, 510, 350, 822, 825],
    "permutation": [226, 22, 108, 253, 196, 9, 638, 674, 352, 357, 492, 217,
        818, 473, 866, 676, 500, 127, 922, 978, 555, 947, 391, 479, 482,
        518, 670, 319, 130, 698, 985, 583, 802, 620, 424, 948, 103, 675,
        214, 180, 561, 882, 57, 84, 629, 166, 23, 74, 810, 413, 470, 159,
        756, 925, 918, 101, 907, 649, 345, 175, 254, 515, 995, 296, 883,
        991, 567, 512, 994, 789, 527, 655, 354, 429, 156, 639, 187, 705,
        275, 917, 910, 570, 516, 650, 875, 123, 181, 823, 846, 791, 760, 37,
        606, 953, 627, 697, 138, 762, 408, 276, 66, 361, 472, 722, 8, 386,
        921, 142, 538, 755, 605, 867, 318, 517, 55, 716, 931, 455, 940, 541,
        467, 302, 309, 271, 14, 621, 982, 936, 39, 934, 331, 663, 462, 96,
        904, 402, 314, 68, 734, 204, 150, 803, 454, 313, 983, 968, 543, 209,
        307, 381, 137, 798, 33, 906, 337, 422, 558, 415, 273, 658, 475, 616,
        43, 744, 695, 758, 416, 647, 954, 374, 826, 387, 719, 874, 855, 911,
        297, 341, 326, 186, 679, 2, 4, 715, 830, 902, 523, 815, 120, 225,
        812, 151, 287, 143, 778, 788, 396, 926, 117, 412, 819, 930, 3, 447,
        367, 20, 613, 693, 323, 218, 690, 859, 128, 255, 244, 506, 718, 385,
        891, 599, 662, 766, 172, 47, 751, 144, 185, 546, 969, 390, 154, 644,
        966, 535, 406, 173, 115, 853, 617, 626, 847, 124, 837, 283, 835,
        822, 78, 905, 139, 216, 521, 463, 939, 632, 816, 848, 452, 298, 427,
        551, 279, 706, 526, 554, 340, 71, 105, 666, 471, 824, 950, 495, 943,
        795, 964, 770, 636, 310, 16, 118, 776, 92, 493, 550, 277, 335, 125,
        237, 772, 997, 140, 246, 901, 420, 72, 884, 428, 678, 136, 491, 736,
        773, 560, 608, 368, 370, 507, 18, 176, 986, 536, 399, 933, 250, 941,
        409, 53, 183, 239, 764, 197, 91, 732, 768, 912, 505, 784, 126, 585,
        63, 860, 611, 219, 266, 50, 194, 320, 598, 403, 32, 633, 453, 793,
        979, 809, 990, 915, 844, 998, 295, 871, 963, 34, 348, 269, 64, 592,
        384, 753, 169, 668, 549, 280, 888, 565, 711, 805, 688, 85, 960, 262,
        394, 94, 774, 999, 739, 797, 82, 817, 971, 421, 466, 430, 61, 235,
        865, 79, 377, 637, 588, 993, 804, 305, 863, 992, 457, 268, 920, 568,
        40, 221, 669, 81, 783, 464, 602, 540, 970, 981, 324, 752, 862, 369,
        278, 316, 182, 885, 556, 988, 522, 487, 436, 569, 223, 245, 958,
        808, 508, 528, 761, 667, 267, 58, 375, 97, 28, 1, 800, 132, 153,
        790, 76, 566, 292, 42, 414, 285, 435, 380, 338, 48, 147, 955, 152,
        654, 961, 157, 502, 270, 228, 294, 485, 574, 231, 965, 332, 222,
        597, 578, 450, 83, 376, 411, 191, 234, 444, 900, 529, 145, 35, 260,
        31, 308, 317, 315, 525, 476, 531, 689, 474, 957, 27, 344, 342, 383,
        913, 21, 104, 519, 919, 733, 730, 265, 51, 562, 441, 59, 513, 684,
        281, 100, 828, 748, 532, 366, 769, 178, 976, 796, 545, 311, 322,
        771, 121, 10, 122, 431, 300, 590, 811, 534, 207, 757, 257, 5, 845,
        842, 146, 708, 240, 26, 600, 19, 102, 460, 746, 461, 12, 680, 759,
        572, 959, 640, 261, 946, 167, 360, 503, 174, 775, 677, 110, 236,
        831, 163, 938, 932, 258, 591, 483, 451, 927, 648, 673, 841, 148,
        480, 418, 160, 86, 49, 77, 511, 827, 664, 141, 898, 443, 199, 564,
        165, 459, 289, 870, 346, 709, 850, 973, 190, 665, 62, 703, 488, 177,
        645, 458, 170, 685, 189, 205, 780, 740, 202, 834, 580, 806, 864,
        343, 861, 75, 646, 737, 623, 635, 439, 162, 889, 989, 158, 895, 119,
        392, 490, 282, 293, 557, 510, 754, 701, 200, 398, 30, 692, 13, 914,
        624, 52, 351, 683, 604, 952, 977, 878, 630, 849, 263, 389, 723, 363,
        249, 395, 785, 652, 552, 88, 325, 942, 714, 843, 401, 291, 869, 353,
        909, 696, 682, 290, 984, 155, 544, 509, 886, 333, 499, 634, 6, 735,
        581, 498, 501, 935, 400, 378, 417, 373, 892, 749, 962, 537, 857,
        833, 419, 794, 213, 350, 601, 903, 56, 577, 90, 738, 264, 184, 489,
        397, 782, 659, 661, 520, 433, 610, 584, 220, 46, 107, 872, 628, 712,
        304, 713, 854, 93, 687, 807, 69, 192, 868, 704, 89, 168, 731, 745,
        135, 609, 179, 643, 336, 116, 625, 671, 7, 359, 161, 233, 607, 224,
        469, 312, 87, 593, 25, 548, 481, 15, 371, 210, 779, 975, 542, 193,
        571, 916, 814, 727, 212, 301, 468, 801, 631, 211, 388, 504, 603,
        425, 533, 256, 11, 339, 787, 618, 586, 171, 699, 893, 252, 897, 728,
        763, 0, 829, 17, 524, 987, 576, 448, 852, 813, 514, 404, 750, 247,
        700, 839, 575, 497, 355, 579, 873, 36, 672, 29, 477, 129, 980, 836,
        365, 596, 929, 478, 742, 825, 786, 587, 721, 553, 106, 227, 44, 328,
        242, 382, 259, 208, 595, 686, 928, 95, 437, 321, 899, 362, 945, 725,
        206, 24, 426, 729, 423, 651, 656, 272, 879, 657, 702, 594, 967, 720,
        777, 614, 622, 54, 446, 619, 358, 494, 201, 109, 188, 438, 133, 851,
        840, 432, 563, 434, 767, 660, 405, 589, 349, 547, 972, 951, 974,
        924, 65, 215, 877, 937, 582, 923, 306, 484, 327, 456, 832, 949, 347,
        741, 896, 229, 890, 330, 198, 131, 858, 45, 134, 530, 164, 440, 70,
        956, 944, 717, 496, 449, 111, 642, 379, 445, 410, 248, 908, 241,
        232, 747, 251, 98, 612, 539, 880, 710, 329, 465, 356, 653, 393, 372,
        486, 288, 838, 856, 691, 792, 996, 821, 726, 887, 559, 238, 67, 364,
        41, 876, 299, 781, 73, 743, 641, 60, 442, 799, 38, 284, 694, 80,
        724, 203, 149, 615, 113, 573, 894, 334, 407, 707, 114, 820, 286,
        881, 99, 765, 195, 243, 274, 230, 112, 681, 303],
}


def random_known_answers(device):
    """The package's draws for ``RANDOM_KNOWN``'s questions on ``device``
    (the accelerator mode, ``x64=False``, on either device), each position
    drawn alone as a one-element flat range."""
    import torch

    from nums_tpu_torch.core.ops import random_ops, threefry

    key = threefry.fold_in(
        threefry.seed_key(RANDOM_KNOWN["seed"], False),
        RANDOM_KNOWN["counter"])
    out = {"bits": [], "random": [], "normal": [], "integers": []}
    for shape, positions in (
            ((N_FULL, D_FULL), RANDOM_KNOWN["positions"]),
            ((4 * N_FULL, D_FULL), RANDOM_KNOWN["positions_beyond_2_32"])):
        for p in positions:
            at = (p, p + 1)
            bits = threefry.random_bits(key, shape, 32, device, *at)
            out["bits"].append(int(bits.item()) & 0xFFFFFFFF)
            out["random"].append(float(random_ops.jr_uniform(
                key, shape, torch.float32, device, flat_range=at).item()))
            out["normal"].append(float(random_ops.jr_normal(
                key, shape, torch.float32, device, flat_range=at).item()))
            out["integers"].append(int(random_ops.jr_randint(
                key, shape, 0, 1000, torch.int32, device, False,
                flat_range=at).item()))
    out["permutation"] = random_ops.permutation(key, 1000, device).tolist()
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_err(got, ref):
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / max(scale, 1e-30)


def time_ms(fn, reps=5):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _sass_functions(path, nvcc):
    """{function name: SASS text} of a built library (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def phase_build():
    from nums_tpu_torch.core.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    secs = time.perf_counter() - t0
    for line in _build.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "warning" in line):
            print(line.strip(), file=sys.stderr)
    # Guard against a silent SIMT build: the gram must run on the tensor
    # cores, whose sm_90a instruction is HGMMA.
    funcs = _sass_functions(path, _build.nvcc_path())
    mma = [body for name, body in funcs.items() if "gram_mma" in name]
    assert len(mma) == 1, ("gram_mma in the SASS", sorted(funcs))
    hgmma = mma[0].count("HGMMA")
    assert hgmma > 0, "gram_mma's SASS holds no HGMMA instruction"
    # The Newton passes are bound by memory: each must load 16 bytes a
    # thread (every instance of a template).
    wide = {}
    for kern in ("newton_eta", "newton_grad_scale"):
        bodies = [body for name, body in funcs.items() if kern in name]
        assert bodies, (kern, "not in the SASS", sorted(funcs))
        wide[kern] = [body.count("LDG.E.128") for body in bodies]
        assert all(wide[kern]), f"{kern}'s SASS holds no LDG.E.128"
    # The host libraries of the I/O layer. Without them the package takes
    # numpy's routes and says nothing: on the card that is a failure.
    from nums_tpu_torch.core.io import _native, shard_native

    host = {}
    for name, module in (("csv_parser", _native),
                         ("shard_io", shard_native)):
        t0 = time.perf_counter()
        assert module.get_lib() is not None, (
            f"{name}.cpp did not build", _build.host_compilers())
        host[name] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs, "library": path.name,
          "gram_mma_hgmma_instructions": hgmma,
          "ldg_e_128_instructions": wide, "host_library_seconds": host})


SMALL_SHAPES = [(1003, 97), (2049, 1001), (37, 1), (4099, 130), (5, 64),
                (64, 128), (65, 129), (130, 1025), (63, 1), (4100, 28),
                (4100, 29)]


def _check_xt(torch, xt, ref, what):
    """A staged bf16 copy (d_pad, n_pad) is ``ref`` (n, d, float32)
    transposed, bit for bit, and zero in the pad."""
    n, d = ref.shape
    assert torch.equal(xt[:d, :n], ref.T.to(torch.bfloat16)), (what, n, d)
    assert not bool(xt[d:].any()) and not bool(xt[:, n:].any()), (
        "pad not zero", what, n, d)


def _check_stage(torch, cuda_gram, x, w, mode):
    """The staged copy is the plain rounding of Xᵀ."""
    _check_xt(torch, cuda_gram.stage(x, w, mode),
              cuda_gram.stage_plain(x, w, mode), ("staged copy", mode))


def _check_newton_parts(torch, cuda_gram, cuda_newton, x, staged, y, beta,
                        kind, g_rel):
    """newton_eta and newton_grad_scale on ``staged`` (X staged once),
    each against its plain version on the same inputs, twice bitwise
    equal; the scaled operand is the plain mode-2 rounding with the
    kernel's own weight, zero in the pad. eta is a sum over one row, held
    to SMALL_REL at every size; g sums all n rows, held to ``g_rel``.
    Returns the largest absolute errors of (eta, g)."""
    n = x.shape[0]
    rb, wb = cuda_newton.eta(staged, y, beta, kind)
    again = cuda_newton.eta(staged, y, beta, kind)
    xb = cuda_gram.round_bf16(x)
    plain = cuda_newton.eta_plain(xb, y, beta, kind)
    eta_err = 0.0
    for got, twice, ref in zip((rb, wb), again, plain):
        if ref is None:
            assert got is None and twice is None, kind
            continue
        assert torch.equal(got, twice), (kind, "newton_eta not repeatable")
        assert not bool(got[n:].any()), (kind, "newton_eta pad not zero")
        err, rel = rel_err(got[:n], ref)
        assert rel <= SMALL_REL, (kind, "newton_eta", x.shape, rel)
        eta_err = max(eta_err, err)
    del again, plain
    g, xs = cuda_newton.grad_scale(staged, rb, wb)
    g2, xs2 = cuda_newton.grad_scale(staged, rb, wb)
    pg, _ = cuda_newton.grad_scale_plain(xb, rb[:n].float(), None)
    del xb
    torch.cuda.synchronize()
    assert torch.equal(g, g2), (kind, "newton_grad_scale not repeatable")
    g_err, rel = rel_err(g, pg)
    assert rel <= g_rel, (kind, "newton_grad_scale g", x.shape, rel)
    if wb is None:
        assert xs is None and xs2 is None, kind
        return eta_err, g_err
    assert torch.equal(xs, xs2), (kind, "scaled operand not repeatable")
    del xs2
    # sqrt(w²) = w exactly for a bf16 w, so this is bf16(bf16(x)·w).
    w = wb[:n].float()
    _check_xt(torch, xs, cuda_gram.stage_plain(
        x, w * w, cuda_gram.MODE_SCALE_BF16), ("scaled operand", kind))
    return eta_err, g_err


def phase_small(torch):
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    modes = (("gram", cuda_gram.MODE_X),
             ("gram_weighted", cuda_gram.MODE_SCALE_F32),
             ("gram_weighted_bf16_scale", cuda_gram.MODE_SCALE_BF16))
    worst = {name: 0.0 for name, _ in modes}
    worst.update(newton_stats=0.0, newton_eta=0.0, newton_grad_scale=0.0)
    for n, d in SMALL_SHAPES:
        x = torch.randn(n, d, generator=gen, device=DEVICE)
        s = torch.rand(n, generator=gen, device=DEVICE)
        for name, mode in modes:
            w = None if mode == cuda_gram.MODE_X else s
            _check_stage(torch, cuda_gram, x, w, mode)
            g = cuda_gram.gram(x, w, mode)
            again = cuda_gram.gram(x, w, mode)
            p = cuda_gram.gram_plain(x, w, mode)
            torch.cuda.synchronize()
            err, rel = rel_err(g, p)
            assert torch.equal(g, again), (name, n, d, "not repeatable")
            assert torch.equal(g, g.T), (name, n, d, "not symmetric")
            assert rel <= SMALL_REL, (name, n, d, rel)
            worst[name] = max(worst[name], err)
        y = (torch.rand(n, generator=gen, device=DEVICE) > 0.5).float()
        beta = 0.05 * torch.randn(d, generator=gen, device=DEVICE)
        staged = cuda_newton.prepare(x)
        assert torch.equal(staged.xt, cuda_newton.prepare_plain(x).xt), (
            "prepare", n, d)
        for kind in cuda_newton.KINDS:
            pg, ph = cuda_newton.stats_plain(x, y, beta, kind)
            for form, arg in (("x", x), ("staged", staged)):
                g, h = cuda_newton.stats(arg, y, beta, kind)
                g2, h2 = cuda_newton.stats(arg, y, beta, kind)
                torch.cuda.synchronize()
                assert torch.equal(g, g2) and torch.equal(h, h2), (
                    kind, form, n, d, "not repeatable")
                assert torch.equal(h, h.T), (kind, form, n, d,
                                             "H not symmetric")
                for got, ref, what in ((g, pg, "g"), (h, ph, "H")):
                    err, rel = rel_err(got, ref)
                    assert rel <= SMALL_REL, (kind, form, what, n, d, rel)
                    worst["newton_stats"] = max(worst["newton_stats"], err)
            eta_err, g_err = _check_newton_parts(
                torch, cuda_gram, cuda_newton, x, staged, y, beta, kind,
                SMALL_REL)
            worst["newton_eta"] = max(worst["newton_eta"], eta_err)
            worst["newton_grad_scale"] = max(worst["newton_grad_scale"],
                                             g_err)
    emit({"phase": "kernels_vs_plain_small", "shapes": SMALL_SHAPES,
          "tolerance_rel": SMALL_REL, "max_abs_err": worst})


def _gram64(x, chunk=1 << 18):
    import torch

    g = torch.zeros(x.shape[1], x.shape[1], dtype=torch.float64,
                    device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        g += c.T @ c
    return g


def _mean_var64(torch, x, chunk=1 << 24):
    """Mean and variance of every element of ``x``, float64 sums taken a
    chunk at a time."""
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    squares = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, flat.numel(), chunk):
        c = flat[i:i + chunk].double()
        total += c.sum()
        squares += (c * c).sum()
    mean = float(total) / flat.numel()
    return mean, float(squares) / flat.numel() - mean * mean


def _upper_pair_flops(n, d, tile=128):
    """Multiply-adds x 2 of the upper tile pairs the gram kernel computes,
    its zero pad included: the rate it runs at."""
    t = -(-d // tile)
    return 2.0 * n * (t * (t + 1) // 2) * tile * tile


def _triangle_flops(n, d):
    """Multiply-adds x 2 of the gram's upper triangle, its diagonal
    included: the work the function needs, for its bound."""
    return 1.0 * n * d * (d + 1)


def _reset_counts():
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    for counts in (cuda_gram.LAUNCHES, cuda_newton.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counts():
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    return {**cuda_gram.LAUNCHES, **cuda_newton.LAUNCHES}


def phase_main_path(torch):
    import nums_tpu_torch
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.models.glms import LogisticRegression

    app = nums_tpu_torch.init()
    assert app.backend.device.type == DEVICE, app.backend.device
    assert settings.matmul_precision == "default", settings.matmul_precision
    # The library's draw of the same array, timed first and dropped: one
    # in-place normal_ of a torch generator. The port calls it nowhere.
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1337)
    lib = torch.empty((N_FULL, D_FULL), dtype=torch.float32, device=DEVICE)
    lib.normal_(generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib.normal_(generator=gen)
    torch.cuda.synchronize()
    library_draw_secs = time.perf_counter() - t0
    del lib, gen
    torch.cuda.empty_cache()

    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rs = app.random_state(RANDOM_KNOWN["seed"])
    X = rs.normal(shape=(N_FULL, D_FULL), block_shape=(N_FULL, D_FULL),
                  dtype=np.float32)
    torch.cuda.synchronize()
    draw_secs = time.perf_counter() - t0
    x_bytes = 4.0 * N_FULL * D_FULL
    draw_peak_above = torch.cuda.max_memory_allocated() - base_bytes
    assert rs.get_state()["counter"] == RANDOM_KNOWN["counter"]
    assert X.data.dtype == torch.float32 and X.data.is_cuda
    assert draw_peak_above <= x_bytes + DRAW_SCRATCH_BYTES, (
        "the draw's peak device memory above the output", draw_peak_above)
    draw_bound_ms, _ = _bound(x_bytes, 0.0)
    # X is the reference's X for this seed: the known answers, at their
    # flat positions of X itself.
    at = torch.tensor(RANDOM_KNOWN["positions"], device=DEVICE)
    known = torch.tensor(RANDOM_KNOWN["normal"][:len(at)],
                         dtype=torch.float64, device=DEVICE)
    x_at = X.data.view(-1)[at].double()
    known_err = float((x_at - known).abs().max())
    assert bool(((x_at - known).abs() <= NORMAL_KNOWN_REL * known.abs()
                 + NORMAL_KNOWN_ABS).all()), (x_at.tolist(), known.tolist())
    x_mean, x_var = _mean_var64(torch, X.data)
    assert abs(x_mean) <= X_MEAN_ABS and abs(x_var - 1.0) <= X_VAR_ABS, (
        x_mean, x_var)
    draw = {"seconds": draw_secs, "library_seconds": library_draw_secs,
            "library": "torch.Tensor.normal_(generator=torch.Generator)",
            "bound_ms": draw_bound_ms, "bound_by": "bytes",
            "peak_above_base_bytes": draw_peak_above,
            "output_bytes": x_bytes,
            "scratch_limit_bytes": DRAW_SCRATCH_BYTES,
            "known_answers_max_abs_err": known_err,
            "mean": x_mean, "var": x_var}
    G = X.T @ X
    G.touch()
    gram_launches = _counts()["gram"]
    assert gram_launches >= 1, "X.T @ X did not launch the gram kernel"
    # Labels from a true beta with logistic noise (not separable).
    beta_true = rs.normal(scale=0.1, shape=(D_FULL,), dtype=np.float32)
    u = rs.uniform(shape=(N_FULL,), dtype=np.float32)
    eta = X @ beta_true
    y = (app.one / (app.one + app.exp(-eta)) > u).astype(np.float32)
    model = LogisticRegression(**FIT).fit(X, y)
    acc = float(model.score(X, y))
    main_secs = time.perf_counter() - t0
    counts = _counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    # The fit stages X once and runs the statistics (and their weighted
    # gram) once per iteration: newton_fit runs all max_iter steps.
    assert counts["newton_stage"] == 1, counts
    assert counts["newton_stats"] == FIT["max_iter"], counts
    assert counts["gram_weighted"] == FIT["max_iter"], counts

    g64 = _gram64(X.data)
    _, gram_rel = rel_err(G.data, g64)
    assert G.shape == (D_FULL, D_FULL) and bool(torch.isfinite(G.data).all())
    assert gram_rel <= BF16_REL, ("gram vs float64", gram_rel)
    assert torch.equal(G.data, G.data.T), "G not symmetric"
    del g64
    acc_true = float(((eta > 0).astype(np.float32) == y).mean())
    assert abs(acc - acc_true) <= ACC_SLACK, (acc, acc_true)
    beta_k = torch.cat([model.coef_.data, model.intercept_.data[None]])
    assert bool(torch.isfinite(beta_k).all())

    settings.matmul_precision = "highest"
    try:
        ref = LogisticRegression(**FIT).fit(X, y)
    finally:
        settings.matmul_precision = "default"
    beta_h = torch.cat([ref.coef_.data, ref.intercept_.data[None]])
    _, beta_rel = rel_err(beta_k, beta_h)
    assert beta_rel <= BETA_REL, ("beta: kernels vs highest", beta_rel)
    # Phase 15 holds the mesh's draw, gram, beta and accuracy to these.
    keep = {"gram": G.data.cpu(), "beta": beta_k.cpu(), "accuracy": acc,
            "x_checksum": int(_x_checksum(torch, X.data))}
    emit({"phase": "main_path", "shape": [N_FULL, D_FULL],
          "seconds": main_secs, "launches": counts, "draw": draw,
          "max_memory_allocated_bytes": peak_bytes,
          "gram_rel_err_vs_f64": gram_rel, "gram_tolerance": BF16_REL,
          "accuracy": acc, "accuracy_true_beta": acc_true,
          "beta_rel_err_vs_highest": beta_rel, "beta_tolerance": BETA_REL})
    return app, X, y, model, counts, ref, acc_true, draw, keep


def _bound(bytes_moved, tc_flops, f32_flops=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate
    and the operations of each type over that type's peak rate (the
    tensor cores and the f32 units run side by side)."""
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(tc_flops / BF16_TC_FLOPS, f32_flops / F32_FLOPS) * 1e3
    return max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations"


def _gram_bound(n, d, weighted=False):
    """The gram's bound: X (and the weights) read once in fp32, G written
    once, its upper triangle on the tensor cores."""
    return _bound(4.0 * n * d + (4.0 * n if weighted else 0.0) + 4.0 * d * d,
                  _triangle_flops(n, d))


def _k3_bound(n, da, x_bytes):
    """K3's bound: X read once at ``x_bytes`` a value (2: the staged bf16
    copy; 4: the fp32 X of a one-shot call), y and beta read, g and H
    written; the gram's triangle on the tensor cores, eta's and g's
    4·n·d on the f32 units."""
    return _bound(x_bytes * n * da + 4.0 * n + 8.0 * da + 4.0 * da * da,
                  _triangle_flops(n, da), 4.0 * n * da)


def _library_gram(torch):
    """(fn, what): cuBLAS's gram of bf16 operands, float32 out where this
    torch's mm takes ``out_dtype``, else bf16 out. The port never calls
    it; it is the yardstick of K1 and K2."""
    probe = torch.ones(64, 64, device=DEVICE, dtype=torch.bfloat16)
    try:
        torch.mm(probe, probe, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda a: torch.mm(a.T, a)), "torch.mm, bf16 output"
    return ((lambda a: torch.mm(a.T, a, out_dtype=torch.float32)),
            "torch.mm(out_dtype=float32)")


def _time_k3(torch, cuda_gram, cuda_newton, xa, staged, yd, beta, kind):
    """K3 of one kind at full size: held to its plain version, the staged
    and one-shot forms bitwise equal, each part held to its plain version
    as in phase 3 (g to FULL_REL), and the times of both forms, the plain
    version and each part."""
    g, h = cuda_newton.stats(staged, yd, beta, kind)
    g1, h1 = cuda_newton.stats(xa, yd, beta, kind)
    assert torch.equal(g, g1) and torch.equal(h, h1), (kind, "forms differ")
    del g1, h1
    pg, ph = cuda_newton.stats_plain(xa, yd, beta, kind)
    err_g, rel_g = rel_err(g, pg)
    err_h, rel_h = rel_err(h, ph)
    assert max(rel_g, rel_h) <= FULL_REL, ("stats at full size", kind,
                                            rel_g, rel_h)
    del g, h, pg, ph
    eta_err, grad_err = _check_newton_parts(
        torch, cuda_gram, cuda_newton, xa, staged, yd, beta, kind, FULL_REL)
    rb, wb = cuda_newton.eta(staged, yd, beta, kind)
    _, xs = cuda_newton.grad_scale(staged, rb, wb)
    hx = staged.xt if xs is None else xs
    out = {
        "max_abs_err": max(err_g, err_h), "rel_err": max(rel_g, rel_h),
        "newton_eta_max_abs_err": eta_err,
        "newton_grad_scale_max_abs_err": grad_err,
        "ms": time_ms(lambda: cuda_newton.stats(staged, yd, beta, kind)),
        "one_shot_ms": time_ms(lambda: cuda_newton.stats(xa, yd, beta,
                                                         kind)),
        "plain_ms": time_ms(
            lambda: cuda_newton.stats_plain(xa, yd, beta, kind)),
        "newton_eta_ms": time_ms(
            lambda: cuda_newton.eta(staged, yd, beta, kind)),
        "newton_grad_scale_ms": time_ms(
            lambda: cuda_newton.grad_scale(staged, rb, wb)),
        "gram_ms": time_ms(
            lambda: cuda_gram.gram_staged(hx, staged.d, xs is not None)),
    }
    del rb, wb, xs, hx
    return out


def phase_times(torch, smi, X, y, model):
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
    from nums_tpu_torch.models.glms import LogisticRegression

    out = {}
    lib_gram, lib_what = _library_gram(torch)
    x = X.data
    n, d = x.shape
    g, p = cuda_gram.gram(x), cuda_gram.gram_plain(x)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("gram at full size", rel)
    # Which side carries the f32 summation error: both against a float64
    # sum of the same bf16-rounded inputs.
    exact = _gram64(cuda_gram.round_bf16(x))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del p, exact
    _, lib_rel = rel_err(lib_gram(x.to(torch.bfloat16)).float(), g)
    del g
    out["gram"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(x)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(x)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(x)),
        "matmul_fp32_ms": time_ms(lambda: x.T @ x),
        "library_ms": time_ms(lambda: lib_gram(x.to(torch.bfloat16))),
        "library_call": lib_what, "library_rel_err_vs_kernel": lib_rel,
    }
    out["gram"]["upper_pair_tflops"] = (
        _upper_pair_flops(n, d) / out["gram"]["ms"] / 1e9)
    out["gram"]["bound_ms"], out["gram"]["bound_by"] = _gram_bound(n, d)
    xa = torch.cat([x, torch.ones(n, 1, device=x.device)], dim=1)
    del x
    da = d + 1
    beta = 0.5 * torch.cat([model.coef_.data, model.intercept_.data[None]])
    mu = torch.sigmoid(xa @ beta)
    s = mu * (1.0 - mu)
    del mu
    g, p = cuda_gram.gram(xa, s), cuda_gram.gram_plain(xa, s)
    err, rel = rel_err(g, p)
    assert rel <= FULL_REL, ("weighted gram at full size", rel)
    exact = _gram64(cuda_gram.stage_plain(xa, s))
    _, kernel_rel64 = rel_err(g, exact)
    _, plain_rel64 = rel_err(p, exact)
    del p, exact

    def scaled_bf16():
        return (xa * s.sqrt()[:, None]).to(torch.bfloat16)

    _, lib_rel = rel_err(lib_gram(scaled_bf16()).float(), g)
    del g
    out["gram_weighted"] = {
        "max_abs_err": err, "rel_err": rel,
        "kernel_rel_err_vs_f64": kernel_rel64,
        "plain_rel_err_vs_f64": plain_rel64,
        "ms": time_ms(lambda: cuda_gram.gram(xa, s)),
        "stage_ms": time_ms(lambda: cuda_gram.stage(xa, s)),
        "plain_ms": time_ms(lambda: cuda_gram.gram_plain(xa, s)),
        "library_ms": time_ms(lambda: lib_gram(scaled_bf16())),
        "library_call": lib_what, "library_rel_err_vs_kernel": lib_rel,
    }
    out["gram_weighted"]["bound_ms"], out["gram_weighted"]["bound_by"] = (
        _gram_bound(n, da, weighted=True))
    yd = y.data
    # K3: X staged once, as a fit stages it; the parts of a call, and the
    # cuBLAS sequence of the same steps (no one library call computes
    # K3's function, so it has no library time: context only).
    staged = cuda_newton.prepare(xa)
    out["newton_stats"] = _time_k3(torch, cuda_gram, cuda_newton, xa,
                                   staged, yd, beta, "logistic")
    out["newton_stats"]["stage_ms"] = time_ms(
        lambda: cuda_newton.prepare(xa))
    # K3's bound is for the call its "ms" times, on the staged copy.
    out["newton_stats"]["bound_ms"], out["newton_stats"]["bound_by"] = (
        _k3_bound(n, da, 2.0))
    out["newton_stats"]["one_shot_bound_ms"], _ = _k3_bound(n, da, 4.0)
    xb = xa.to(torch.bfloat16)

    def cublas_sequence():
        mu = torch.sigmoid((xb @ beta.to(torch.bfloat16)).float())
        w = (mu * (1.0 - mu)).sqrt().to(torch.bfloat16)
        xb.T @ (mu - yd).to(torch.bfloat16)
        return lib_gram(xb * w[:, None])

    out["newton_stats"]["cublas_sequence_ms"] = time_ms(cublas_sequence)
    del xb, s
    # The linear and Poisson kinds of K3 (phase 7's fused fits), at a
    # Poisson-sized beta: eta ~ N(0, 0.25), as phase 7 plants it.
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    beta_p = (0.5 / D_FULL ** 0.5) * torch.randn(
        da, generator=gen, device=DEVICE)
    for kind in ("linear", "poisson"):
        out[f"newton_stats_{kind}"] = _time_k3(
            torch, cuda_gram, cuda_newton, xa, staged, yd, beta_p, kind)
    del xa, staged

    def fit():
        LogisticRegression(**FIT).fit(X, y)

    out["fit_10_iter"] = {"ms": time_ms(fit)}
    settings.matmul_precision = "highest"
    try:
        out["fit_10_iter"]["highest_ms"] = time_ms(fit)
    finally:
        settings.matmul_precision = "default"
    emit({"phase": "times", "card": smi, "shape": [N_FULL, D_FULL],
          "tolerance_rel": FULL_REL, "times": out})
    return out


def _profiled(torch, fn):
    """One call of ``fn`` under torch.profiler: (wall ms on the host clock
    after a synchronize, device ms by kernel name, calls by kernel name).
    The profiler's table goes to standard error."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    print(table, file=sys.stderr, flush=True)
    kernels, calls = {}, {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            ms = e.device_time_total / 1e3
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
            calls[e.name] = calls.get(e.name, 0) + 1
    return wall_ms, kernels, calls


def _profile_summary(torch, fn):
    """One call of ``fn`` under torch.profiler: (wall and device ms, the
    device's idle share and the eight kernels that took longest; calls by
    kernel name)."""
    wall_ms, kernels, calls = _profiled(torch, fn)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "kernels_ms": dict(top),
            "kernel_calls": {k: calls[k] for k, _ in top}}, calls


def phase_profile(torch, X, y):
    """Device time by kernel over one 10-iteration fit (torch.profiler),
    and the fit's launch counts (set to 0 just before it, read just
    after); returns the counts."""
    from nums_tpu_torch.models.glms import LogisticRegression

    LogisticRegression(**FIT).fit(X, y)  # warm-up
    _reset_counts()
    summary, calls = _profile_summary(
        torch, lambda: LogisticRegression(**FIT).fit(X, y))
    counts = _counts()
    stage_calls = sum(c for k, c in calls.items() if "gram_stage" in k)
    assert stage_calls == 1, ("one staging pass per fit", calls)
    emit({"phase": "profile", **summary, "gram_stage_calls": stage_calls,
          "launches": counts})
    return counts


# Phase 7, on phase 4's X (2.5M x 1000 fp32, the reference's size):
FAM_SEED = 2024
FAM_FIT = dict(tol=1e-8, max_iter=10)  # the fused fits and their refits
EAGER_LINEAR_ITERS = 3   # tol 0: every iteration runs, one K1 launch each
EXP_FIT = dict(tol=1e-8, max_iter=8)
EXP_ABS = 0.01           # exponential fit vs its planted beta, absolute
R2_ABS = 1e-3            # R² of the kernel fit vs the "highest" fit
# Lasso: alpha about 16x the noise's correlation with a column, σ/√n =
# 6.3e-5, so the 980 planted zeros stay exactly zero; float32 ADMM stops
# at max|β - z|, ρ·max|Δz| <= tol, against a float64 ADMM on the float64
# moments of the same X.
LASSO = dict(alpha=1e-3, tol=1e-4, max_iter=500)
LASSO_REF = dict(tol=1e-7, max_iter=3000)
# BFGS stops on max|g| < tol (g is O(1e5) at beta = 0) or on a line
# search that runs out of float32 digits; irls runs all its iterations.
LBFGS = dict(penalty="l2", tol=1.0, max_iter=100)
IRLS = dict(tol=1e-8, max_iter=10)
SOLVER_REL = 1e-3        # Lasso, lbfgs, irls vs their references


def _beta_of(torch, model):
    return torch.cat([model.coef_.data, model.intercept_.data[None]])


def _timed_fit(torch, make, X, y):
    """(model, seconds, launches, peak device bytes) of
    ``make().fit(X, y)``: the counts are set to 0 just before the fit and
    read just after it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model = make().fit(X, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return model, secs, _counts(), torch.cuda.max_memory_allocated()


def _highest(torch, make, X, y):
    """The same fit with plain fp32 ops (no kernel)."""
    from nums_tpu_torch.core import settings

    settings.matmul_precision = "highest"
    try:
        model, secs, counts, _ = _timed_fit(torch, make, X, y)
    finally:
        settings.matmul_precision = "default"
    assert not any(counts.values()), ("highest launched a kernel", counts)
    return model, secs


def _targets(torch, X):
    """Phase 7's labels from planted coefficients, drawn from generators
    seeded here: linear, Poisson (eta ~ N(0, 0.25)), exponential on the
    same eta, and sparse linear (20 nonzeros)."""
    n, d = X.shape
    x = X.data
    gen = torch.Generator(device=DEVICE).manual_seed(FAM_SEED)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    w_lin = 0.1 * normal(d)
    y_lin = x @ w_lin + 0.5 + 0.1 * normal(n)
    w_p = (0.5 / d ** 0.5) * normal(d)
    mu = torch.exp(x @ w_p)
    y_p = torch.poisson(mu, generator=gen)
    y_e = mu * torch.empty_like(mu).exponential_(1.0, generator=gen)
    del mu
    support = torch.randperm(
        d, generator=torch.Generator().manual_seed(FAM_SEED))[:20]
    w_s = torch.zeros(d, device=DEVICE)
    w_s[support.to(DEVICE)] = (
        (0.5 + 0.5 * torch.rand(20, generator=gen, device=DEVICE))
        * torch.where(normal(20) < 0, -1.0, 1.0))
    y_s = x @ w_s + 0.3 + 0.1 * normal(n)
    return (w_lin, y_lin), (w_p, y_p, y_e), (w_s, y_s)


def _moments64(torch, x, y, chunk=1 << 18):
    """[X, 1]ᵀ[X, 1] and [X, 1]ᵀy summed in float64, in row panels."""
    d = x.shape[1] + 1
    G = torch.zeros(d, d, dtype=torch.float64, device=x.device)
    q = torch.zeros(d, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        c = torch.cat([c, torch.ones(c.shape[0], 1, dtype=c.dtype,
                                     device=c.device)], dim=1)
        G += c.T @ c
        q += c.T @ y[i:i + chunk].double()
    return G, q


def phase_glm_families(torch, app, X, y, logistic_ref):
    """Every GLM family and solver beside phase 4's, at "default"
    precision, each held to its check:

    | fit                              | route            | must launch   |
    |----------------------------------|------------------|---------------|
    | LinearRegression(newton)         | fused, K3 linear | newton_stats  |
    | Ridge(alpha=1)                   | fused, K3 linear | newton_stats  |
    | LinearRegression, glm_fuse "0"   | eager, K1        | gram = iters  |
    | PoissonRegression(newton)        | fused, K3 poisson| newton_stats, |
    |                                  |                  | gram_weighted |
    | ExponentialRegression(newton)    | eager, plain ops |               |
    | Lasso(alpha=1e-3)                | ADMM, plain ops  |               |
    | LogisticRegression(lbfgs, l2)    | BFGS, plain ops  |               |
    | LogisticRegression(irls)         | eager, plain ops |               |
    """
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.models import fast_glm
    from nums_tpu_torch.models.glms import (
        ExponentialRegression, Lasso, LinearRegression, LogisticRegression,
        PoissonRegression, Ridge,
    )

    (w_lin, y_lin), (w_p, y_p, y_e), (w_s, y_s) = _targets(torch, X)
    n = X.shape[0]

    def ba(t):
        return BlockArray.from_torch(t, block_shape=(n,), backend=app.backend)

    fits = {}

    def record(name, fit, **checks):
        _, secs, counts, peak = fit
        fits[name] = {"seconds": secs, "launches": counts,
                      "peak_bytes": peak, **checks}
        print(json.dumps({name: fits[name]}), file=sys.stderr, flush=True)

    # Linear and Ridge, fused: K3's linear kind.
    by = ba(y_lin)
    lin_models = {}
    for name, make in (
        ("linear_newton", lambda: LinearRegression(solver="newton",
                                                   **FAM_FIT)),
        ("ridge", lambda: Ridge(alpha=1.0, **FAM_FIT)),
    ):
        fit = _timed_fit(torch, make, X, by)
        model, _, counts, _ = fit
        assert counts["newton_stage"] == 1, (name, counts)
        assert counts["newton_stats"] == counts["gram"] == FAM_FIT[
            "max_iter"], (name, counts)
        ref, ref_secs = _highest(torch, make, X, by)
        _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
        r2, r2_ref = float(model.score(X, by)), float(ref.score(X, by))
        assert rel <= BETA_REL, (name, "beta vs highest", rel)
        assert abs(r2 - r2_ref) <= R2_ABS, (name, r2, r2_ref)
        if name == "ridge":
            assert float(model._lambda_vec.data[-1]) == 0.0
        lin_models[name] = model
        record(name, fit, highest_seconds=ref_secs,
               beta_rel_err_vs_highest=rel, r2=r2, r2_highest=r2_ref)

    # Linear, eager Newton: X.T @ X through K1 at 2.5M x 1001, once per
    # iteration (the iterations are counted at the solve).
    solves = []
    solve = app.posdef_solve
    app.posdef_solve = lambda A, b: solves.append(1) or solve(A, b)
    settings.glm_fuse = "0"
    try:
        fit = _timed_fit(
            torch, lambda: LinearRegression(
                solver="newton", tol=0.0, max_iter=EAGER_LINEAR_ITERS),
            X, by)
    finally:
        settings.glm_fuse = "1"
        del app.posdef_solve
    model, _, counts, _ = fit
    assert counts["gram"] == len(solves) == EAGER_LINEAR_ITERS, (
        counts, len(solves))
    assert counts["newton_stats"] == 0, counts
    _, rel = rel_err(_beta_of(torch, model),
                     _beta_of(torch, lin_models["linear_newton"]))
    assert rel <= BETA_REL, ("eager vs fused linear", rel)
    record("linear_eager_newton", fit, iterations=len(solves),
           beta_rel_err_vs_fused=rel)

    # Poisson, fused: K3's Poisson kind.
    byp = ba(y_p)

    def make():
        return PoissonRegression(solver="newton", **FAM_FIT)

    fit = _timed_fit(torch, make, X, byp)
    model, _, counts, _ = fit
    assert counts["newton_stage"] == 1, counts
    assert counts["newton_stats"] == counts["gram_weighted"] == FAM_FIT[
        "max_iter"], counts
    ref, ref_secs = _highest(torch, make, X, byp)
    _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
    assert rel <= BETA_REL, ("poisson beta vs highest", rel)
    dev = float(model.deviance(byp, model.predict(X)))
    assert np.isfinite(dev) and dev >= 0.0, dev
    record("poisson_newton", fit, highest_seconds=ref_secs,
           beta_rel_err_vs_highest=rel, deviance=dev)
    del byp

    # Exponential, eager Newton on plain ops: the planted beta.
    fit = _timed_fit(
        torch, lambda: ExponentialRegression(solver="newton", **EXP_FIT),
        X, ba(y_e))
    model = fit[0]
    err = max(float((model.coef_.data - w_p).abs().max()),
              abs(float(model.intercept_.data)))
    assert err <= EXP_ABS, ("exponential vs planted beta", err)
    record("exponential_newton", fit, max_abs_err_vs_planted=err)

    # Lasso by ADMM, against a float64 ADMM on float64 moments.
    bys = ba(y_s)
    fit = _timed_fit(torch, lambda: Lasso(**LASSO), X, bys)
    model = fit[0]
    G, q = _moments64(torch, X.data, y_s)
    z, _, ref_it = fast_glm.admm_fit_gram(
        G, q, torch.zeros_like(q), LASSO_REF["tol"],
        max_iter=LASSO_REF["max_iter"], penalty="l1",
        lambda_vec=model._lambda_vec.data.double())
    del G
    _, rel = rel_err(_beta_of(torch, model), z)
    coef = model.coef_.data
    planted_zeros_exact = bool((coef[w_s == 0] == 0).all())
    assert rel <= SOLVER_REL, ("lasso vs float64 admm", rel)
    assert planted_zeros_exact, "a planted zero of the lasso is not 0"
    record("lasso_admm", fit, beta_rel_err_vs_f64_admm=rel,
           f64_admm_iterations=int(ref_it),
           nonzeros=int((coef != 0).sum()),
           planted_zeros_exact=planted_zeros_exact)
    del bys

    # Logistic by BFGS (l2) and by IRLS, against the fused Newton at
    # "highest" (phase 4's unpenalized fit for IRLS).
    searches = []
    search = fast_glm._line_search
    fast_glm._line_search = lambda *a: searches.append(1) or search(*a)
    try:
        fit = _timed_fit(
            torch, lambda: LogisticRegression(solver="lbfgs", **LBFGS), X, y)
    finally:
        fast_glm._line_search = search
    model = fit[0]
    ref, ref_secs = _highest(
        torch, lambda: LogisticRegression(solver="newton", penalty="l2",
                                          **FAM_FIT), X, y)
    _, rel = rel_err(_beta_of(torch, model), _beta_of(torch, ref))
    assert rel <= SOLVER_REL, ("lbfgs vs newton", rel)
    record("logistic_lbfgs_l2", fit, iterations=len(searches),
           newton_highest_seconds=ref_secs, beta_rel_err_vs_newton=rel)
    fit = _timed_fit(
        torch, lambda: LogisticRegression(solver="irls", **IRLS), X, y)
    _, rel = rel_err(_beta_of(torch, fit[0]), _beta_of(torch, logistic_ref))
    assert rel <= SOLVER_REL, ("irls vs newton", rel)
    record("logistic_irls", fit, beta_rel_err_vs_newton=rel)

    emit({"phase": "glm_families", "shape": [N_FULL, D_FULL],
          "max_memory_allocated_bytes": max(
              f["peak_bytes"] for f in fits.values()),
          "fits": fits})
    return fits


# Phase 8, on phase 4's X and y, streamed from disk:
OOC_PANEL_ROWS = 250_000     # 10 panels of 1.0 GB at 2.5M x 1000 fp32
OOC_MIN_FREE_BYTES = 25e9    # the 10 GB spill and its predictions, twice over
OOC_PEAK_PANELS = 8          # peak device memory of the streamed steps
OOC_LABEL_MISMATCH = 1e-4    # predict_ooc (host fp32) vs predict (card)
STATS_BF16_REL = 4e-3        # K2's H vs K3's: bf16(x·√s) vs
                             # bf16(bf16(x)·bf16(√s)) (test_pallas_newton.py:11)


def _ooc_stats_pass(torch, app, dX, y_at, beta, kind):
    """(g, H) of one streamed Newton statistics pass over ``dX``, as
    ``newton_fit_ooc`` makes it: each panel moved, augmented on the card
    and folded by ``streaming.glm_stats_update_aug``."""
    from nums_tpu_torch.core.array.application import ooc_panels, ooc_put
    from nums_tpu_torch.core.ops import streaming

    da = dX.shape[1] + 1
    g = torch.zeros(da, device=DEVICE)
    H = torch.zeros(da, da, device=DEVICE)
    for start, panel in ooc_panels(dX):
        yp, _ = ooc_put(app.backend, y_at(start, panel.shape[0]))
        pa, _ = ooc_put(app.backend, panel, augment_ones=True)
        streaming.glm_stats_update_aug(kind, g, H, pa, yp, beta)
    return g, H


def _ooc_counted(torch, launches, fn):
    """fn() with the launch counts set to 0 just before it and read just
    after (synchronized), added into ``launches``; returns (result,
    seconds, counts)."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return out, secs, counts


def _ooc_pass_parts(torch, app, dX):
    """One pass taken apart, on the host clock: the disk (or page cache)
    read of every panel alone, then each panel's move to the card
    (``ooc_put``, as the gram takes it and augmented as the fit takes
    it) alone."""
    from nums_tpu_torch.core.array.application import ooc_put

    t0 = time.perf_counter()
    for _ in dX.iter_row_panels():
        pass
    read_s = time.perf_counter() - t0
    put = {False: 0.0, True: 0.0}
    for _, panel in dX.iter_row_panels():
        for augment in put:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _ = ooc_put(app.backend, panel, augment_ones=augment)
            torch.cuda.synchronize()
            put[augment] += time.perf_counter() - t0
            del p
    return {"host_read_s": read_s, "host_to_device_s": put[False],
            "host_to_device_augment_s": put[True]}


def _ooc_panel_kernels(torch, app, dX, dy, beta):
    """K1, K2 and K3 (one-shot) on one resident panel of the streamed
    path: ``_kernels_at`` that shape."""
    from nums_tpu_torch.core.array.application import ooc_put

    p, _ = ooc_put(app.backend, dX.row_panel(0))
    pa, _ = ooc_put(app.backend, dX.row_panel(0), augment_ones=True)
    yp, _ = ooc_put(app.backend, dy.row_panel(0))
    return _kernels_at(torch, p, pa, yp, beta)


def _kernels_at(torch, p, pa, yp, beta, staged=None):
    """K1 on ``p``, K2 and K3 on ``pa`` (``p`` with its column of ones;
    K3 one-shot, or on ``staged``, ``pa`` staged once as a fit stages it),
    each held to its plain version at FULL_REL and timed by CUDA events
    beside its plain version and its bound."""
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton

    rows, d, da = p.shape[0], p.shape[1], pa.shape[1]
    mu = torch.sigmoid(pa @ beta)
    s = mu * (1.0 - mu)
    del mu
    k3_x = pa if staged is None else staged
    calls = {
        "gram": (lambda: cuda_gram.gram(p),
                 lambda: cuda_gram.gram_plain(p), _gram_bound(rows, d)),
        "gram_weighted": (lambda: cuda_gram.gram(pa, s),
                          lambda: cuda_gram.gram_plain(pa, s),
                          _gram_bound(rows, da, weighted=True)),
        "newton_stats": (
            lambda: cuda_newton.stats(k3_x, yp, beta, "logistic"),
            lambda: cuda_newton.stats_plain(pa, yp, beta, "logistic"),
            _k3_bound(rows, da, 4.0 if staged is None else 2.0)),
    }
    out = {}
    for name, (kernel, plain, (bound_ms, bound_by)) in calls.items():
        got, ref = kernel(), plain()
        if name != "newton_stats":
            got, ref = (got,), (ref,)
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        rel = max(r for _, r in errs)
        assert rel <= FULL_REL, (name, "at", tuple(pa.shape), rel)
        del got, ref
        out[name] = {"shape": [rows, da if name != "gram" else d],
                     "max_abs_err": max(e for e, _ in errs),
                     "rel_err": rel, "ms": time_ms(kernel),
                     "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                     "bound_by": bound_by}
    return out


OOC_COMPONENTS = 16
OOC_GATE_OFF_REL = 1e-4      # fp32 moments vs float64 moments
ORTHONORMAL_ABS = 1e-5
OOC_TRANSFORM_REL = 1e-4     # the streamed transform vs the in-core one


def _ooc_decomposition(torch, app, launches, x, g64, dX, root):
    """PCA and TruncatedSVD fitted on the DiskArray (one streamed pass of
    moments each, K1 per panel) and their streamed ``transform``.

    Held: exactly one ``gram`` launch per panel per fit and none per
    transform; explained variances within BF16_REL of the largest of a
    float64 reference (the top eigenvalues of the float64 covariance for
    PCA; s²/n − (μᵀv)² from the float64 gram's eigenpairs for
    TruncatedSVD); the same fits with the gram gate off within
    OOC_GATE_OFF_REL; components orthonormal to ORTHONORMAL_ABS; the
    transformed file's first and last panel within OOC_TRANSFORM_REL of
    the in-core ``transform`` of the same rows."""
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.models.decomposition import PCA, TruncatedSVD

    n, d = x.shape
    k = OOC_COMPONENTS
    panels = dX.num_row_panels
    mu = torch.zeros(d, dtype=torch.float64, device=x.device)
    for i in range(0, n, 1 << 18):
        mu += x[i:i + (1 << 18)].sum(dim=0, dtype=torch.float64)
    mu /= n
    cov = (g64 - n * torch.outer(mu, mu)) / (n - 1)
    pca_ref = torch.linalg.eigvalsh(cov).flip(0)[:k]
    evals, evecs = torch.linalg.eigh(g64)
    evals, evecs = evals.flip(0)[:k], evecs.flip(1)[:, :k]
    tsvd_ref = evals / n - (evecs.T @ mu) ** 2
    del cov, evecs
    eye = torch.eye(k, device=x.device)
    out = {}
    for name, cls, ref in (("pca", PCA, pca_ref),
                           ("truncated_svd", TruncatedSVD, tsvd_ref)):
        model, fit_s, c = _ooc_counted(
            torch, launches, lambda: cls(n_components=k).fit(dX))
        assert c["gram"] == panels and c["gram_weighted"] == 0, (name, c)
        assert c["newton_stats"] == c["newton_stage"] == 0, (name, c)
        gate, settings.gram_kernel = settings.gram_kernel, "0"
        try:
            plain, plain_s, c = _ooc_counted(
                torch, launches, lambda: cls(n_components=k).fit(dX))
        finally:
            settings.gram_kernel = gate
        assert not any(c.values()), (name, "gate off launched a kernel", c)
        ev = model.explained_variance_.data
        assert ev.shape == (k,) and bool(torch.isfinite(ev).all()), name
        _, rel = rel_err(ev, ref)
        _, plain_rel = rel_err(plain.explained_variance_.data, ref)
        assert rel <= BF16_REL, (name, "explained variance", rel)
        assert plain_rel <= OOC_GATE_OFF_REL, (name, "gate off", plain_rel)
        comps = model.components_.data
        ortho = float((comps @ comps.T - eye).abs().max())
        assert comps.shape == (k, d) and ortho <= ORTHONORMAL_ABS, (
            name, "components", ortho)
        disk, transform_s, c = _ooc_counted(
            torch, launches,
            lambda: model.transform(dX, out=os.path.join(root, name)))
        assert not any(c.values()), (name, "transform launched a kernel", c)
        assert disk.shape == (n, k) and disk.num_row_panels == panels, disk
        worst = 0.0
        for i in (0, panels - 1):
            start = dX.grid.grid_slices[0][i][0]
            rows = BlockArray.from_torch(
                x[start:start + OOC_PANEL_ROWS], backend=app.backend)
            core = model.transform(rows).data
            got = torch.from_numpy(disk.row_panel(i)).to(core.device)
            _, t_rel = rel_err(got, core)
            assert t_rel <= OOC_TRANSFORM_REL, (name, "transform", i, t_rel)
            worst = max(worst, t_rel)
        out[name] = {
            "fit_s": fit_s, "gate_off_fit_s": plain_s,
            "transform_s": transform_s,
            "explained_variance_rel_err_vs_f64": rel,
            "gate_off_rel_err_vs_f64": plain_rel,
            "components_orthonormal_abs_err": ortho,
            "transform_rel_err_vs_in_core": worst,
        }
    return out


def _ooc_kmeans(torch, app, launches, X, dX, root, base):
    """KMeans(16) on the DiskArray, ``KM_OOC_ITER`` passes at tol 0 and
    the final inertia pass, against in-core Lloyd's from the same
    first-panel seeding; ``predict_ooc`` against the in-core ``predict``;
    its own peak device memory above ``base``."""
    from nums_tpu_torch.models import cluster

    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km, out["fit_s"], c = _ooc_counted(torch, launches, lambda: cluster.KMeans(
        n_clusters=KM_K, max_iter=KM_OOC_ITER, tol=0.0,
        seed=KM_SEED).fit(dX))
    assert not any(c.values()), c
    assert km.n_iter_ == KM_OOC_ITER, km.n_iter_
    out["fit_s_per_pass"] = out["fit_s"] / (KM_OOC_ITER + 1)
    labels_ooc, out["predict_ooc_s"], c = _ooc_counted(
        torch, launches, lambda: km.predict_ooc(
            dX, out=os.path.join(root, "km_labels")))
    assert not any(c.values()), c
    out["peak_above_base_bytes"] = torch.cuda.max_memory_allocated() - base
    x = X.data
    sample = x[:dX.grid.block_shape[0]]
    centers = cluster._plusplus_init(KM_K, KM_SEED, sample,
                                     cluster._row_sq_norms(sample), False)
    xx = cluster._row_sq_norms(x)
    for _ in range(KM_OOC_ITER):
        _, sums, counts = cluster._assign_stats(x, centers, KM_K, xx)
        centers, _ = cluster._update(centers, sums, counts)
    _, out["centers_rel_err_vs_in_core"] = rel_err(
        km.cluster_centers_.data, centers)
    assert out["centers_rel_err_vs_in_core"] <= KM_OOC_REL, out
    got = np.concatenate([p for _, p in labels_ooc.iter_row_panels()])
    want = km.predict(X).get()
    out["predict_mismatch_rows"] = int((got != want).sum())
    assert got.dtype == want.dtype and out["predict_mismatch_rows"] == 0, out
    out["inertia"] = km.inertia_
    return out


def phase_ooc(torch, smi, app, X, y, model, acc_true):
    """Out of core at full width: phase 4's X and y written to disk in
    panels of OOC_PANEL_ROWS rows and streamed back through the public
    entry points, each held to its in-core or float64 reference:

    | step                               | kernels per panel             |
    |------------------------------------|-------------------------------|
    | spill: DiskArray.from_panels       | none (card -> disk)           |
    | app.gram_ooc                       | K1                            |
    | LogisticRegression.fit(dX, dy)     | K3 one-shot, per iteration    |
    | one statistics pass, Newton gate 0 | K2 (after one pass with K3)   |
    | app.linear_regression_ooc          | K1                            |
    | PCA / TruncatedSVD .fit(dX)        | K1 (the streamed moments)     |
    | their .transform(dX)               | none (one fp32 GEMM)          |
    | model.predict_ooc, save, load      | none (host panels)            |
    | KMeans(16).fit(dX), predict_ooc    | none (one fp32 GEMM a panel)  |

    The launch counts of each step are set to 0 just before it and read
    just after; the peak device memory of the streamed steps is taken
    above what was allocated before them."""
    import shutil
    import tempfile

    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.application import _ooc_y_getter
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.array.diskarray import DiskArray
    from nums_tpu_torch.core.ops import cuda_gram, streaming
    from nums_tpu_torch.models.glms import GLM, LogisticRegression

    n, d = X.shape
    rows = OOC_PANEL_ROWS
    panels = -(-n // rows)
    panel_bytes = rows * d * 4
    x = X.data
    # In-core references first: the in-core gram stages a 5 GB copy.
    g_core = (X.T @ X).data
    g64 = _gram64(x)
    beta_core = _beta_of(torch, model)
    (_, y_lin), _, _ = _targets(torch, X)
    m64, q64 = _moments64(torch, x, y_lin)
    theta64 = torch.linalg.solve(m64[:d, :d], q64[:d])
    del m64, q64
    by_lin = BlockArray.from_torch(y_lin, backend=app.backend)

    os.makedirs(settings.data_dir, exist_ok=True)
    free = shutil.disk_usage(settings.data_dir).free
    assert free >= OOC_MIN_FREE_BYTES, (
        f"phase 8 needs {OOC_MIN_FREE_BYTES / 1e9:.0f} GB free under "
        f"{settings.data_dir}; {free / 1e9:.1f} GB are free")
    root = tempfile.mkdtemp(prefix="chip_smoke_ooc-", dir=settings.data_dir)
    out = {"phase": "ooc", "card": smi, "shape": [n, d],
           "panel_rows": rows, "panels": panels, "data_dir_free_bytes": free}
    launches = {}
    try:
        t0 = time.perf_counter()
        dX = DiskArray.from_panels(
            os.path.join(root, "X"), app.fs,
            (x[i:i + rows].cpu().numpy() for i in range(0, n, rows)),
            (n, d), np.float32, rows)
        dy = DiskArray.from_panels(
            os.path.join(root, "y"), app.fs,
            (y.data[i:i + rows].cpu().numpy() for i in range(0, n, rows)),
            (n,), np.float32, rows)
        out["spill_s"] = time.perf_counter() - t0
        assert dX.num_row_panels == dy.num_row_panels == panels

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        G, out["gram_ooc_s"], c = _ooc_counted(
            torch, launches, lambda: app.gram_ooc(dX).data)
        assert c["gram"] == panels and c["gram_weighted"] == 0, c
        assert c["newton_stats"] == c["newton_stage"] == 0, c
        assert G.shape == (d, d) and bool(torch.isfinite(G).all())
        _, out["gram_rel_err_vs_f64"] = rel_err(G, g64)
        _, out["gram_rel_err_vs_in_core"] = rel_err(G, g_core)
        assert out["gram_rel_err_vs_f64"] <= BF16_REL, out
        assert out["gram_rel_err_vs_in_core"] <= FULL_REL, out
        del G, g_core

        steps = []
        newton_update = streaming.newton_update
        streaming.newton_update = (
            lambda *a: steps.append(1) or newton_update(*a))
        try:
            fitted, out["fit_s"], c = _ooc_counted(
                torch, launches,
                lambda: LogisticRegression(**FIT).fit(dX, dy))
        finally:
            streaming.newton_update = newton_update
        it = len(steps)
        out["fit_iterations"] = it
        out["fit_s_per_iteration"] = out["fit_s"] / it
        assert c["newton_stats"] == c["newton_stage"] == c[
            "gram_weighted"] == panels * it, (c, it)
        assert c["gram"] == 0, c
        beta_ooc = _beta_of(torch, fitted)
        _, out["beta_rel_err_vs_in_core"] = rel_err(beta_ooc, beta_core)
        assert out["beta_rel_err_vs_in_core"] <= BETA_REL, out

        # K2 against K3 on one pass at half the fitted beta, rounded to
        # bf16: at the fit's optimum g is the rounding noise of each route,
        # and no relative tolerance holds it (at half of it g is far from
        # 0); K3's eta takes bf16(beta), which would shift its g from the
        # plain g of the K2 route by about 2^-9 of g, a bf16 beta by none.
        beta_half = cuda_gram.round_bf16(0.5 * beta_ooc)
        y_at = _ooc_y_getter(dX, dy)
        (g3, h3), out["k3_pass_s"], c = _ooc_counted(
            torch, launches,
            lambda: _ooc_stats_pass(torch, app, dX, y_at, beta_half,
                                    "logistic"))
        assert c["newton_stats"] == c["gram_weighted"] == panels, c
        gate, settings.newton_kernel = settings.newton_kernel, "0"
        try:
            (g2, h2), out["k2_pass_s"], c = _ooc_counted(
                torch, launches,
                lambda: _ooc_stats_pass(torch, app, dX, y_at, beta_half,
                                        "logistic"))
        finally:
            settings.newton_kernel = gate
        assert c["gram_weighted"] == panels and c["gram"] == 0, c
        assert c["newton_stats"] == c["newton_stage"] == 0, c
        _, out["k2_vs_k3_g_rel_err"] = rel_err(g2, g3)
        _, out["k2_vs_k3_h_rel_err"] = rel_err(h2, h3)
        assert out["k2_vs_k3_g_rel_err"] <= FULL_REL, out
        assert out["k2_vs_k3_h_rel_err"] <= STATS_BF16_REL, out
        del g2, h2, g3, h3

        theta, out["linear_regression_ooc_s"], c = _ooc_counted(
            torch, launches,
            lambda: app.linear_regression_ooc(dX, by_lin).data)
        assert c["gram"] == panels and c["gram_weighted"] == 0, c
        _, out["linear_regression_rel_err_vs_f64"] = rel_err(theta, theta64)
        assert out["linear_regression_rel_err_vs_f64"] <= BETA_REL, out
        out["decomposition"] = _ooc_decomposition(
            torch, app, launches, x, g64, dX, root)
        del g64
        peak = torch.cuda.max_memory_allocated()
        out["kmeans"] = _ooc_kmeans(torch, app, launches, X, dX, root, base)
        out["peak_above_base_bytes"] = (
            max(peak, torch.cuda.max_memory_allocated()) - base)
        out["peak_limit_bytes"] = OOC_PEAK_PANELS * panel_bytes
        assert out["peak_above_base_bytes"] <= out["peak_limit_bytes"], out

        t0 = time.perf_counter()
        pred = fitted.predict_ooc(dX, out=os.path.join(root, "pred"))
        out["predict_ooc_s"] = time.perf_counter() - t0
        labels = np.concatenate([p for _, p in pred.iter_row_panels()])
        assert labels.shape == (n,), labels.shape
        out["accuracy"] = float((labels == y.get()).mean())
        out["accuracy_true_beta"] = acc_true
        assert abs(out["accuracy"] - acc_true) <= ACC_SLACK, out
        in_core = fitted.predict(X).get()
        out["predict_mismatch_share"] = float((labels != in_core).mean())
        assert out["predict_mismatch_share"] <= OOC_LABEL_MISMATCH, out

        fitted.save(os.path.join(root, "model"))
        back = GLM.load(os.path.join(root, "model"))
        assert type(back) is LogisticRegression
        assert torch.equal(_beta_of(torch, back), beta_ooc), "save/load"

        out.update(_ooc_pass_parts(torch, app, dX))
        out["panel"] = _ooc_panel_kernels(torch, app, dX, dy, beta_half)
        per_pass = panels * out["panel"]["newton_stats"]["ms"] / 1e3
        out["fit_device_share"] = per_pass / out["fit_s_per_iteration"]
        out["launches"] = launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


# Phase 9: the linalg layer. TSQR at 2^24 x 128 fp32 is the reference's
# own linalg target shape (BASELINE.json), not cut.
LA_M, LA_N = 1 << 24, 128
LA_BLOCKS = 8                # A is drawn in row blocks of 2^21 rows
LA_SEED = 4242
LA_COMPONENTS = 16
LA_QR_REL = 1e-5             # max|QR − A| / max|A|
LA_R_REL = 1e-4              # |R| of one route vs another's
LA_S_REL = 1e-5              # singular values vs float64 gram eigenvalues
LA_THETA_REL = 1e-4          # θ̂ vs the float64 normal equations
LA_RIDGE_BF16_REL = 1e-2     # ridge at "default": RᵀR on the bf16 gram
LA_STREAM_FOOTPRINT = 1.25   # overwrite_x: peak, A included, over A's bytes
LA_SCALER_REL = 1e-5         # StandardScaler round trip vs A
RSVD_REL = 1e-3              # randomized top-16 vs float64 gram eigenvalues
RSVD_DECAY = 0.8             # phase 4's X, column j scaled by 0.8^j


def _clocked(torch, fn, reps, setup=None):
    """One call of ``fn`` for the caller to check, and ``reps`` timed ones
    later, each on ``setup()``'s fresh arguments where given (made outside
    the clock). Returns (the first call's result, info, rest). ``info``
    holds the first call's launch counts (set to 0 just before it, read
    just after) and its peak device memory, in all and above what was
    allocated before it. ``rest()``, called once the caller has dropped
    the result, runs the timed calls and adds ``seconds``: their median on
    the host clock after a synchronize (the first call's own time where
    ``reps`` is 0)."""
    def once():
        args = setup() if setup is not None else ()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return out, secs, _counts(), peak, peak - base

    out, first_s, counts, peak, above = once()
    info = {"first_call_seconds": first_s, "launches": counts,
            "peak_bytes": peak, "peak_above_base_bytes": above,
            "timed_calls": reps}

    def rest():
        times = []
        for _ in range(reps):
            times.append(once()[1])
        info["seconds"] = statistics.median(times) if times else first_s

    return out, info, rest


def _f32_bound(bytes_moved, flops):
    bound_ms, bound_by = _bound(bytes_moved, 0.0, flops)
    return {"bound_ms": bound_ms, "bound_by": bound_by}


def _max_abs_diff(a, b, chunk=1 << 20):
    """max|a − b| over row chunks: no full-size temporary."""
    worst = 0.0
    for i in range(0, a.shape[0], chunk):
        diff = a[i:i + chunk] - b[i:i + chunk]
        worst = max(worst, float(diff.abs().max()))
    return worst


def _qr_errors(torch, q, r, a):
    """(max|QR − A| / max|A|, max|QᵀQ − I|), QᵀQ summed in float64."""
    worst = 0.0
    for i in range(0, a.shape[0], 1 << 20):
        worst = max(worst, float(
            (q[i:i + (1 << 20)] @ r - a[i:i + (1 << 20)]).abs().max()))
    eye = torch.eye(q.shape[1], dtype=torch.float64, device=q.device)
    return (worst / float(a.abs().max()),
            float((_gram64(q) - eye).abs().max()))


def phase_linalg_wide(torch, app, X):
    """``randomized_svd`` and the randomized PCA at 2.5M x 1000 fp32, on
    phase 4's X with column j scaled in place by RSVD_DECAY^j (floored at
    1e-4): N(0,1) draws alone have a flat spectrum, in which no sketch
    finds a top 16. Held to the eigenvalues of a float64 gram (and of the
    float64 covariance) within RSVD_REL."""
    from nums_tpu_torch.models.decomposition import PCA

    n, d = X.shape
    k = LA_COMPONENTS
    x = X.data
    x.mul_(torch.clamp(RSVD_DECAY ** torch.arange(
        d, dtype=torch.float64, device=x.device), min=1e-4).float())
    g64 = _gram64(x)
    s_ref = torch.linalg.eigvalsh(g64).flip(0)[:k].sqrt()
    mu = torch.zeros(d, dtype=torch.float64, device=x.device)
    for i in range(0, n, 1 << 18):
        mu += x[i:i + (1 << 18)].sum(dim=0, dtype=torch.float64)
    mu /= n
    ev_ref = torch.linalg.eigvalsh(
        (g64 - n * torch.outer(mu, mu)) / (n - 1)).flip(0)[:k]
    del g64
    ell = k + 10
    # Six products with X (the sketch, two per power iteration, the
    # projection) and the back-projection; X read once, U, S, Vᵀ written.
    bound = _f32_bound(4.0 * n * d + 4.0 * (n * k + k + k * d),
                       12.0 * n * d * ell + 2.0 * n * ell * k)
    calls = {}

    (U, S, VT), info, rest = _clocked(
        torch, lambda: app.randomized_svd(X, k), 3)
    assert U.shape == (n, k) and S.shape == (k,) and VT.shape == (k, d)
    _, info["singular_values_rel_err_vs_f64"] = rel_err(S.data, s_ref)
    assert info["singular_values_rel_err_vs_f64"] <= RSVD_REL, info
    eye = torch.eye(k, dtype=torch.float64, device=x.device)
    info["utu_abs_err"] = float((_gram64(U.data) - eye).abs().max())
    assert info["utu_abs_err"] <= ORTHONORMAL_ABS, info
    del U, S, VT
    rest()
    calls["randomized_svd"] = {**info, **bound}
    print(json.dumps({"randomized_svd": calls["randomized_svd"]}),
          file=sys.stderr, flush=True)

    model, info, rest = _clocked(
        torch, lambda: PCA(n_components=k, svd_solver="randomized").fit(X), 3)
    _, info["explained_variance_rel_err_vs_f64"] = rel_err(
        model.explained_variance_.data, ev_ref)
    assert info["explained_variance_rel_err_vs_f64"] <= RSVD_REL, info
    comps = model.components_.data
    info["components_orthonormal_abs_err"] = float(
        (comps @ comps.T - eye.float()).abs().max())
    assert info["components_orthonormal_abs_err"] <= ORTHONORMAL_ABS, info
    del model, comps
    rest()
    calls["pca_randomized"] = {**info, **bound}
    print(json.dumps({"pca_randomized": calls["pca_randomized"]}),
          file=sys.stderr, flush=True)
    assert not any(c["launches"][name] for c in calls.values()
                   for name in c["launches"]), calls
    return {"shape": [n, d], "components": k, "column_decay": RSVD_DECAY,
            "calls": calls}


def phase_linalg(torch, smi, app, wide):
    """The linalg entry points at 2^24 x 128 fp32, A = N(0,1) drawn on the
    card through the app's generator in row blocks, y = Aθ + 0.01·noise:

    | call                          | route          | held to              |
    |-------------------------------|----------------|----------------------|
    | indirect_tsr                  | cholqr_r       | |R| of the routes    |
    | indirect_tsqr                 | cholqr_r, GEMM | QR − A               |
    | direct_tsqr                   | cholqr2        | QR − A, QᵀQ − I      |
    | direct_tsqr(overwrite_x=True) | cholqr2_stream | the same; footprint  |
    | svd                           | svd_cholqr     | S (float64 gram)     |
    | linear_, fast_linear_regr.    | cholqr2 / _r   | θ̂ (float64 solve)    |
    | ridge_regression(lamb=1)      | cholqr_r + K1  | 1 launch, θ̂ 1e-2;    |
    |   K1 on that call's R         |                | plain 1e-5, f64 2e-3 |
    |   the same at "highest"       | cholqr_r       | 0 launches, θ̂ 1e-4   |
    | PCA(16).fit_transform         | svd_cholqr     | float64 covariance   |
    | StandardScaler round trip     | plain ops      | A itself             |
    | indirect_tsr, direct_tsqr     | Householder    | as above, timed once |

    ``indirect_tsqr``'s Q is X·R⁻¹ with an explicit inverse: its QᵀQ − I is
    recorded and not held. ``overwrite_x`` runs on a copy it may destroy.
    Each call's launch counts are set to 0 just before its first, checked
    call and read just after; the times are host-clock medians of 3 later
    calls (the Householder calls are timed once, on that first call)."""
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.ops import cuda_gram
    from nums_tpu_torch.models.decomposition import PCA
    from nums_tpu_torch.models.preprocessing import StandardScaler

    m, n, k = LA_M, LA_N, LA_COMPONENTS
    rows = m // LA_BLOCKS
    rs = app.random_state(LA_SEED)
    a = torch.empty((m, n), dtype=torch.float32, device=DEVICE)
    for i in range(LA_BLOCKS):
        a[i * rows:(i + 1) * rows] = rs.normal(
            shape=(rows, n), block_shape=(rows, n), dtype=np.float32).data
    A = BlockArray.from_torch(a, block_shape=(rows, n), backend=app.backend)
    theta = rs.normal(shape=(n,), block_shape=(n,), dtype=np.float32)
    noise = rs.normal(scale=0.01, shape=(m,), block_shape=(rows,),
                      dtype=np.float32)
    Y = A @ theta + noise
    del noise
    a_bytes = 4.0 * m * n
    a_max = float(a.abs().max())

    # float64 references from chunked sums.
    g64 = _gram64(a)
    q64 = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    mu64 = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    for i in range(0, m, 1 << 18):
        c = a[i:i + (1 << 18)].double()
        q64 += c.T @ Y.data[i:i + (1 << 18)].double()
        mu64 += c.sum(dim=0)
    del c
    mu64 /= m
    s_ref = torch.linalg.eigvalsh(g64).flip(0).sqrt()
    theta_ref = torch.linalg.solve(g64, q64)
    ridge_ref = torch.linalg.solve(
        g64 + torch.eye(n, dtype=torch.float64, device=DEVICE), q64)
    ev_ref = torch.linalg.eigvalsh(
        (g64 - m * torch.outer(mu64, mu64)) / (m - 1)).flip(0)[:k]
    theta_scale = float(theta_ref.abs().max())
    # Operations the functions need, as ``_bound`` counts K1's: a gram is
    # its upper triangle, a product with a triangular factor or its
    # inverse mn², a dense product with an n×n matrix 2mn². The routines
    # compute the full squares; the bounds are of the function.
    mn2 = 1.0 * m * n * n
    gram_ops = _triangle_flops(m, n)
    calls, r_of = {}, {}

    def record(name, route, info, rest, bytes_moved, flops):
        rest()
        info["footprint_over_a"] = (
            info["peak_above_base_bytes"] + a_bytes) / a_bytes
        calls[name] = {"route": route, **info,
                       **_f32_bound(bytes_moved, flops)}
        print(json.dumps({name: calls[name]}), file=sys.stderr, flush=True)

    def check_qr(info, Q, R, orthogonal=True):
        assert Q.shape == (m, n) and R.shape == (n, n), (Q.shape, R.shape)
        info["qr_rel_err"], info["qtq_abs_err"] = _qr_errors(
            torch, Q.data, R.data, a)
        assert info["qr_rel_err"] <= LA_QR_REL, info
        if orthogonal:
            assert info["qtq_abs_err"] <= LA_QR_REL, info

    def check_theta(info, got, ref, tol):
        assert got.shape == (n,), got.shape
        err = float((got.data.double() - ref).abs().max()) / theta_scale
        info["theta_err_over_max_theta"] = err
        assert err <= tol, info

    assert settings.tsqr_method == "auto" and app._use_cholqr(A)
    assert settings.matmul_precision == "default"

    R, info, rest = _clocked(torch, lambda: app.indirect_tsr(A), 3)
    r_of["cholqr_r"] = R.data.abs()
    assert torch.equal(R.data, R.data.triu()), "R not upper triangular"
    del R
    record("indirect_tsr", "cholqr_r", info, rest, a_bytes, gram_ops)

    (Q, R), info, rest = _clocked(torch, lambda: app.indirect_tsqr(A), 3)
    check_qr(info, Q, R, orthogonal=False)
    del Q, R
    record("indirect_tsqr", "cholqr_r, X @ inv(R)", info, rest,
           2 * a_bytes, gram_ops + mn2)

    (Q, R), info, rest = _clocked(torch, lambda: app.direct_tsqr(A), 3)
    check_qr(info, Q, R)
    r_of["cholqr2"] = R.data.abs()
    del Q, R
    # Two grams and two right triangular solves.
    cholqr2_ops = 2 * gram_ops + 2 * mn2
    record("direct_tsqr", "cholqr2", info, rest, 2 * a_bytes, cholqr2_ops)

    def copy_of_a():
        return (BlockArray.from_torch(a.clone(), block_shape=(rows, n),
                                      backend=app.backend),)

    (Q, R), info, rest = _clocked(
        torch, lambda C: app.direct_tsqr(C, overwrite_x=True), 3,
        setup=copy_of_a)
    check_qr(info, Q, R)
    _, info["r_rel_err_vs_cholqr2"] = rel_err(R.data.abs(), r_of["cholqr2"])
    assert info["r_rel_err_vs_cholqr2"] <= LA_R_REL, info
    del Q, R
    # Two grams and two chunked products with the inverse factors: the
    # same function as cholqr2.
    record("direct_tsqr_overwrite_x", "cholqr2_stream", info, rest,
           2 * a_bytes, cholqr2_ops)
    assert calls["direct_tsqr_overwrite_x"][
        "footprint_over_a"] <= LA_STREAM_FOOTPRINT, calls

    # Where the two forms of CholeskyQR2 spend their time, by kernel.
    def profile_of(fn):
        wall_ms, kernels, kcalls = _profiled(torch, fn)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        return {"wall_ms": wall_ms, "device_ms": sum(kernels.values()),
                "kernels_ms": dict(top),
                "kernel_calls": {kn: kcalls[kn] for kn, _ in top}}

    profiles = {"direct_tsqr": profile_of(lambda: app.direct_tsqr(A))}
    C, = copy_of_a()
    profiles["direct_tsqr_overwrite_x"] = profile_of(
        lambda: app.direct_tsqr(C, overwrite_x=True))
    del C

    (U, S, VT), info, rest = _clocked(torch, lambda: app.svd(A), 3)
    assert U.shape == (m, n) and S.shape == (n,) and VT.shape == (n, n)
    _, info["singular_values_rel_err_vs_f64"] = rel_err(S.data, s_ref)
    assert info["singular_values_rel_err_vs_f64"] <= LA_S_REL, info
    eye = torch.eye(n, dtype=torch.float64, device=DEVICE)
    info["utu_abs_err"] = float((_gram64(U.data) - eye).abs().max())
    assert info["utu_abs_err"] <= LA_QR_REL, info
    del U, S, VT
    # Why ``linalg._small_svd`` works in float64: the singular values of
    # one fp32 R by torch's default routine in float32 (Jacobi), by
    # cuSOLVER's gesvd in float32, and by the default in float64.
    r = app.indirect_tsr(A).data
    info["r_singular_values_rel_err_by_routine"] = {
        name: rel_err(torch.linalg.svd(arg, full_matrices=False, **kw)[1],
                      s_ref)[1]
        for name, arg, kw in (("float32_default", r, {}),
                              ("float32_gesvd", r, {"driver": "gesvd"}),
                              ("float64_default", r.double(), {}))}
    del r
    # cholqr2, and U = Q times the small SVD's dense factor.
    record("svd", "svd_cholqr", info, rest, 2 * a_bytes,
           cholqr2_ops + 2 * mn2)

    got, info, rest = _clocked(torch, lambda: app.linear_regression(A, Y), 3)
    check_theta(info, got, theta_ref, LA_THETA_REL)
    record("linear_regression", "lstsq_cholqr", info, rest,
           a_bytes + 4.0 * m, cholqr2_ops + 2.0 * m * n)

    got, info, rest = _clocked(
        torch, lambda: app.fast_linear_regression(A, Y), 3)
    check_theta(info, got, theta_ref, LA_THETA_REL)
    record("fast_linear_regression", "cholqr_r, X @ inv(R)", info, rest,
           a_bytes + 4.0 * m, gram_ops + mn2 + 2.0 * m * n)

    # K1 on the operand this path gives it, the upper-triangular R (its
    # diagonal near √m), against its plain version and a float64 RᵀR.
    r = app.indirect_tsr(A).data
    assert r.shape == (n, n) and r.is_contiguous(), (r.shape, r.stride())
    g = cuda_gram.gram(r)
    again = cuda_gram.gram(r)
    torch.cuda.synchronize()
    assert torch.equal(g, again), "gram of R not repeatable"
    assert torch.equal(g, g.T), "gram of R not symmetric"
    k1_abs, k1_rel = rel_err(g, cuda_gram.gram_plain(r))
    assert k1_rel <= SMALL_REL, ("gram of R vs plain", k1_rel)
    _, k1_rel64 = rel_err(g, _gram64(r))
    assert k1_rel64 <= BF16_REL, ("gram of R vs float64", k1_rel64)
    del r, g, again

    got, info, rest = _clocked(
        torch, lambda: app.ridge_regression(A, Y, 1.0), 3)
    check_theta(info, got, ridge_ref, LA_RIDGE_BF16_REL)
    assert info["launches"]["gram"] == 1, info
    assert sum(info["launches"].values()) == 1, info
    info["gram_of_r"] = {"shape": [n, n], "max_abs_err_vs_plain": k1_abs,
                         "rel_err_vs_plain": k1_rel,
                         "rel_err_vs_f64": k1_rel64}
    record("ridge_regression", "cholqr_r, R.T @ R on the gram kernel",
           info, rest, a_bytes + 4.0 * m, gram_ops + 2.0 * m * n)
    linalg_launches = dict(info["launches"])
    settings.matmul_precision = "highest"
    try:
        got, info, rest = _clocked(
            torch, lambda: app.ridge_regression(A, Y, 1.0), 3)
        check_theta(info, got, ridge_ref, LA_THETA_REL)
        assert not any(info["launches"].values()), info
        record("ridge_regression_highest", "cholqr_r, plain R.T @ R",
               info, rest, a_bytes + 4.0 * m, gram_ops + 2.0 * m * n)
    finally:
        settings.matmul_precision = "default"
    del got

    def pca():
        model = PCA(n_components=k)
        return model, model.fit_transform(A)

    (model, Z), info, rest = _clocked(torch, pca, 3)
    assert Z.shape == (m, k), Z.shape
    _, info["explained_variance_rel_err_vs_f64"] = rel_err(
        model.explained_variance_.data, ev_ref)
    assert info["explained_variance_rel_err_vs_f64"] <= LA_S_REL * 10, info
    comps = model.components_.data
    info["components_orthonormal_abs_err"] = float(
        (comps @ comps.T - torch.eye(k, device=DEVICE)).abs().max())
    assert info["components_orthonormal_abs_err"] <= ORTHONORMAL_ABS, info
    # fit_transform is u·s of the fit's SVD: it equals transform.
    _, info["fit_transform_vs_transform_rel_err"] = rel_err(
        Z.data[:1 << 20], model.transform(
            BlockArray.from_torch(a[:1 << 20], backend=app.backend)).data)
    assert info["fit_transform_vs_transform_rel_err"] <= LA_R_REL, info
    del model, Z, comps
    record("pca_fit_transform", "svd_cholqr", info, rest,
           a_bytes + 4.0 * m * k, cholqr2_ops + 2 * mn2)

    def scaler():
        sc = StandardScaler().fit(A)
        Z = sc.transform(A)
        return sc, Z, sc.inverse_transform(Z)

    (sc, Z, back), info, rest = _clocked(torch, scaler, 3)
    info["mean_abs_err_vs_f64"], _ = rel_err(sc.mean_.data, mu64)
    info["round_trip_rel_err"] = _max_abs_diff(back.data, a) / a_max
    assert info["round_trip_rel_err"] <= LA_SCALER_REL, info
    del back
    info["transformed_std_abs_err"] = float(
        (Z.data.std(dim=0) - 1.0).abs().max())
    assert info["transformed_std_abs_err"] <= LA_R_REL, info
    del sc, Z
    # fit reads A; transform and its inverse each read and write one.
    record("standard_scaler_round_trip", "plain ops", info, rest,
           5 * a_bytes, 8.0 * m * n)

    settings.tsqr_method = "householder"
    try:
        assert not app._use_cholqr(A)
        R, info, rest = _clocked(torch, lambda: app.indirect_tsr(A), 0)
        r_of["householder"] = R.data.abs()
        del R
        # Householder's own count, 2mn², is of the routine: the function
        # (R alone) needs no more than cholqr_r's gram.
        record("indirect_tsr_householder", "batched QR tree (R only)",
               info, rest, a_bytes, gram_ops)
        (Q, R), info, rest = _clocked(torch, lambda: app.direct_tsqr(A), 0)
        check_qr(info, Q, R)
        _, info["r_rel_err_vs_r_only_tree"] = rel_err(
            R.data.abs(), r_of["householder"])
        assert info["r_rel_err_vs_r_only_tree"] <= LA_R_REL, info
        del Q, R
        record("direct_tsqr_householder", "batched QR tree", info, rest,
               2 * a_bytes, cholqr2_ops)
    finally:
        settings.tsqr_method = "auto"

    r_rel = {}
    for name in ("cholqr_r", "householder"):
        _, r_rel[f"{name}_vs_cholqr2"] = rel_err(r_of[name], r_of["cholqr2"])
        assert r_rel[f"{name}_vs_cholqr2"] <= LA_R_REL, r_rel
    emit({"phase": "linalg", "card": smi, "shape": [m, n],
          "a_bytes": a_bytes, "tsqr_method": "auto",
          "r_rel_err_between_routes": r_rel,
          "max_memory_allocated_bytes": max(
              c["peak_bytes"] for c in calls.values()),
          "launches": linalg_launches, "calls": calls,
          "cholqr2_profiles": profiles, "wide": wide})
    return linalg_launches


# Phase 10: the HIGGS pipeline (CSV -> split -> logistic fit -> accuracy)
# at the shape of the UCI HIGGS file, 11,000,000 rows of a label and 28
# features, not cut. The file itself is not here: the text is written from
# a seed, N(0,1) features and labels from a planted beta.
HIGGS_ROWS, HIGGS_FEATURES = 11_000_000, 28
HIGGS_SEED = 2014
HIGGS_CHUNK_ROWS = 125_000    # rows a writer process formats at a time
HIGGS_WRITERS = 8             # writer processes, at most the host's cores
HIGGS_PARSE_WORKERS = 16      # byte ranges of read_csv_host
HIGGS_FMT = "%.9g"            # nine significant digits round-trip float32
HIGGS_MIN_FREE_BYTES = 8e9    # the text (3.8 GB), its parts, the checkpoints
HIGGS_BLOCKS = 16             # row blocks of X_test in write_fs and S3
HIGGS_FORMAT_ROWS = 1000      # rows formatted by one % operation


def _higgs_chunk(i, rows, beta):
    """Rows [i·chunk, i·chunk + rows) of the data: x ~ N(0,1) in float32
    and labels from ``beta`` with logistic noise, from a generator seeded
    by (HIGGS_SEED, i). x is drawn first, so x alone can be drawn again."""
    rng = np.random.default_rng([HIGGS_SEED, i])
    x = rng.standard_normal((rows, beta.shape[0]), dtype=np.float32)
    u = rng.random(rows, dtype=np.float32)
    eta = np.einsum("ij,j->i", x, beta)
    y = (1.0 / (1.0 + np.exp(-eta)) > u).astype(np.float32)
    return x, y


def _higgs_write_part(args):
    """Format one chunk as CSV text (label, then the features) into the
    file ``path``; returns the chunk's labels. Runs in a writer process."""
    i, rows, beta, path = args
    x, y = _higgs_chunk(i, rows, beta)
    table = np.concatenate([y[:, None], x], axis=1).astype(np.float64)
    row_fmt = ",".join([HIGGS_FMT] * table.shape[1]) + "\n"
    with open(path, "wb") as f:
        for lo in range(0, rows, HIGGS_FORMAT_ROWS):
            blk = table[lo:lo + HIGGS_FORMAT_ROWS]
            f.write(((row_fmt * len(blk)) % tuple(blk.ravel().tolist()))
                    .encode())
    return y


def _higgs_write_csv(path, beta, workers):
    """Write the whole file: a pool of ``workers`` writer processes formats
    the chunks into part files, appended to ``path`` in order as they
    arrive. Returns the labels."""
    import multiprocessing
    import shutil

    n = HIGGS_ROWS
    jobs = [(i, min(HIGGS_CHUNK_ROWS, n - lo), beta, f"{path}.part{i}")
            for i, lo in enumerate(range(0, n, HIGGS_CHUNK_ROWS))]
    ys = []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool, open(path, "wb") as out:
        for job, y in zip(jobs, pool.imap(_higgs_write_part, jobs)):
            with open(job[3], "rb") as part:
                shutil.copyfileobj(part, out, 1 << 24)
            os.remove(job[3])
            ys.append(y)
    return np.concatenate(ys)


def _higgs_features():
    """The features again, from the chunks' seeds (numpy's generators
    release the GIL: one thread per chunk in flight)."""
    from concurrent.futures import ThreadPoolExecutor

    n = HIGGS_ROWS
    x = np.empty((n, HIGGS_FEATURES), np.float32)

    def fill(job):
        i, lo = job
        rows = min(HIGGS_CHUNK_ROWS, n - lo)
        rng = np.random.default_rng([HIGGS_SEED, i])
        x[lo:lo + rows] = rng.standard_normal((rows, HIGGS_FEATURES),
                                              dtype=np.float32)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(fill, enumerate(range(0, n, HIGGS_CHUNK_ROWS))))
    return x


def _bits_equal(a, b):
    """Equal shape, dtype and bytes (so -0.0 is not 0.0 and nan is nan)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


def _dir_bytes(path):
    """{file name: bytes} of a checkpoint directory."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _higgs_checkpoints(torch, app, Xb, x_host, root):
    """X_test through write_fs/read_fs with the native block engine and
    with it switched off (``shard_native.get_lib`` giving None, as on a
    host without a compiler), then through the s3:// verbs on the
    file-backed fake: arrays bitwise equal, files byte-equal, no object
    left after delete. Returns the seconds of each."""
    import nums_tpu_torch
    from nums_tpu_torch.core.io import shard_native
    from nums_tpu_torch.core.io.fake_s3 import FileBackedFakeS3Client

    out = {}
    calls = {"write": 0, "read": 0}
    write_shards = shard_native.write_shards
    read_windows = shard_native.read_block_windows

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            ok = fn(*args, **kwargs)
            calls[name] += bool(ok)
            return ok
        return wrapper

    def round_trip(route):
        path = os.path.join(root, f"x_test_{route}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.write_fs(Xb, path)
        out[f"write_fs_{route}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = app.read_fs(path)
        torch.cuda.synchronize()
        out[f"read_fs_{route}_s"] = time.perf_counter() - t0
        assert back.block_shape == Xb.block_shape, back.block_shape
        assert _bits_equal(back.get(), x_host), f"read_fs ({route})"
        return path

    shard_native.write_shards = counted("write", write_shards)
    shard_native.read_block_windows = counted("read", read_windows)
    get_lib = shard_native.get_lib
    try:
        native_dir = round_trip("native")
        assert calls == {"write": 1, "read": 1}, calls
        shard_native.get_lib = lambda: None
        numpy_dir = round_trip("numpy")
        assert calls == {"write": 1, "read": 1}, calls
    finally:
        shard_native.get_lib = get_lib
        shard_native.write_shards = write_shards
        shard_native.read_block_windows = read_windows
    assert _dir_bytes(native_dir) == _dir_bytes(numpy_dir), (
        "native and numpy checkpoints differ")
    out["checkpoint_files"] = len(os.listdir(native_dir))

    fake_root = os.path.join(root, "s3")
    client = FileBackedFakeS3Client(fake_root)
    client.create_bucket("higgs")
    old = os.environ.get("NUMS_TPU_TORCH_FAKE_S3_DIR")
    os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"] = fake_root
    try:
        t0 = time.perf_counter()
        nums_tpu_torch.write(Xb, "s3://higgs/x_test")
        out["s3_write_s"] = time.perf_counter() - t0
        out["s3_objects"] = client.list_objects_v2("higgs")["KeyCount"]
        assert out["s3_objects"] == HIGGS_BLOCKS + 1, out
        t0 = time.perf_counter()
        back = nums_tpu_torch.read("s3://higgs/x_test")
        torch.cuda.synchronize()
        out["s3_read_s"] = time.perf_counter() - t0
        assert back.block_shape == Xb.block_shape, back.block_shape
        assert _bits_equal(back.get(), x_host), "s3 read"
        t0 = time.perf_counter()
        nums_tpu_torch.delete("s3://higgs/x_test")
        out["s3_delete_s"] = time.perf_counter() - t0
        assert client.list_objects_v2("higgs")["KeyCount"] == 0
    finally:
        if old is None:
            del os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"]
        else:
            os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"] = old
    return out


def phase_higgs(torch, smi, app):
    """The HIGGS pipeline through the public entry points, on text:

    | step                                        | kernels            |
    |---------------------------------------------|--------------------|
    | the CSV written from a seed (writer pool)   | none (host)        |
    | app.fs.read_csv_host (16 byte ranges)       | none (host C++)    |
    | BlockArray.from_np, app.array               | none (host->card)  |
    | X[:split], X[split:] at 80/20               | none (views)       |
    | X_train.T @ X_train                         | K1, 1 launch       |
    | LogisticRegression(newton).fit              | K3: 1 stage, 10    |
    | predict on the test rows, cold and warm     | none (fp32 GEMV)   |
    | write_fs/read_fs (native, numpy), s3:// verbs | none (card<->host) |

    The launch counts are set to 0 just before the gram and read just
    after the second predict."""
    import resource
    import shutil
    import tempfile
    from io import StringIO

    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.io import _native
    from nums_tpu_torch.core.ops import cuda_newton
    from nums_tpu_torch.models.glms import LogisticRegression

    n, d = HIGGS_ROWS, HIGGS_FEATURES
    os.makedirs(settings.data_dir, exist_ok=True)
    free = shutil.disk_usage(settings.data_dir).free
    assert free >= HIGGS_MIN_FREE_BYTES, (
        f"phase 10 needs {HIGGS_MIN_FREE_BYTES / 1e9:.0f} GB free under "
        f"{settings.data_dir}; {free / 1e9:.1f} GB are free")
    root = tempfile.mkdtemp(prefix="chip_smoke_higgs-", dir=settings.data_dir)
    out = {"phase": "higgs", "card": smi, "shape": [n, d + 1],
           "rows_written": n, "data_dir_free_bytes": free,
           "max_rss_before_bytes": 1024 * resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss}
    t_phase = time.perf_counter()
    try:
        beta_true = (0.3 * np.random.default_rng(HIGGS_SEED).standard_normal(
            d)).astype(np.float32)
        path = os.path.join(root, "higgs.csv")
        out["host_cpus"] = os.cpu_count()
        out["csv_writers"] = max(1, min(HIGGS_WRITERS, os.cpu_count() or 1))
        t0 = time.perf_counter()
        y_true = _higgs_write_csv(path, beta_true, out["csv_writers"])
        out["csv_write_s"] = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        out["csv_mb"] = mb
        t0 = time.perf_counter()
        x_true = _higgs_features()
        out["features_again_s"] = time.perf_counter() - t0

        # Ingest. The file must parse on the native route alone.
        # (The parse threads append: a list's append is atomic.)
        routes = []
        parse_into, parse_bytes = _native.parse_bytes_into, _native.parse_bytes

        def count(route, fn):
            def wrapper(*args):
                routes.append(route)
                return fn(*args)
            return wrapper

        _native.parse_bytes_into = count("native", parse_into)
        _native.parse_bytes = count("numpy", parse_bytes)
        try:
            t0 = time.perf_counter()
            host = app.fs.read_csv_host(path, num_workers=HIGGS_PARSE_WORKERS)
            out["parse_s"] = time.perf_counter() - t0
        finally:
            _native.parse_bytes_into = parse_into
            _native.parse_bytes = parse_bytes
        out["parse_mb_per_s"] = mb / out["parse_s"]
        assert routes == ["native"] * HIGGS_PARSE_WORKERS, routes
        out["parse_route"] = "native"
        out["parse_ranges"] = len(routes)
        assert host.shape == (n, d + 1) and host.dtype == np.float64, (
            host.shape, host.dtype)
        x_host = host[:, 1:].astype(np.float32)
        y_host = host[:, 0].astype(np.float32)
        assert _bits_equal(x_host, x_true), "ingested X differs from its source"
        assert _bits_equal(y_host, y_true), "ingested y differs from its source"
        del x_true, y_true
        # The native parser against numpy's on the same bytes.
        t0 = time.perf_counter()
        ranges = app.fs._byte_ranges(path, HIGGS_PARSE_WORKERS)
        assert len(ranges) == HIGGS_PARSE_WORKERS, ranges
        for start, stop in (ranges[0], ranges[-1]):
            with open(path, "rb") as f:
                f.seek(start)
                raw = f.read(stop - start)
            got, ok = _native.parse_bytes(raw, ",")
            assert ok, "the native parser declined a range"
            ref = np.loadtxt(StringIO(raw.decode()), delimiter=",", ndmin=2)
            assert _bits_equal(got, ref), ("native parse vs np.loadtxt",
                                           start, stop)
            del raw, got, ref
        out["native_vs_loadtxt_s"] = time.perf_counter() - t0

        # Host to device, as the reference's pipeline script does it.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        X = BlockArray.from_np(host[:, 1:].astype(np.float32, copy=False),
                               block_shape=(n, d), backend=app.backend)
        y = app.array(host[:, 0].astype(np.float32, copy=False),
                      block_shape=(n,))
        del host
        torch.cuda.synchronize()
        out["host_to_device_s"] = time.perf_counter() - t0
        assert X.data.device.type == DEVICE and X.data.dtype == torch.float32
        split = int(n * 0.8)
        X_train, y_train = X[:split], y[:split]
        X_test, y_test = X[split:], y[split:]

        _reset_counts()
        t0 = time.perf_counter()
        G = X_train.T @ X_train
        G.touch()
        torch.cuda.synchronize()
        out["gram_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = LogisticRegression(**FIT).fit(X_train, y_train)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        labels = y_test.astype(np.int64)
        for turn in ("cold", "warm"):
            t0 = time.perf_counter()
            acc = float((model.predict(X_test) == labels).mean())
            out[f"predict_{turn}_s"] = time.perf_counter() - t0
        counts = _counts()
        out["launches"] = counts
        assert counts == {"gram": 1, "gram_weighted": FIT["max_iter"],
                          "newton_stage": 1,
                          "newton_stats": FIT["max_iter"]}, counts

        assert G.shape == (d, d) and bool(torch.isfinite(G.data).all())
        _, out["gram_rel_err_vs_f64"] = rel_err(G.data, _gram64(X_train.data))
        assert out["gram_rel_err_vs_f64"] <= BF16_REL, out
        bt = torch.from_numpy(beta_true).to(DEVICE)
        out["accuracy"] = acc
        out["accuracy_true_beta"] = float(
            ((X_test.data @ bt > 0) == (y_test.data > 0.5)).float().mean())
        assert abs(acc - out["accuracy_true_beta"]) <= ACC_SLACK, out
        beta_k = _beta_of(torch, model)
        assert bool(torch.isfinite(beta_k).all())
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        # A second fit, outside the counted path: the first one carries
        # whatever this process set up on its first fit at this width.
        _, out["fit_again_s"], _, _ = _timed_fit(
            torch, lambda: LogisticRegression(**FIT), X_train, y_train)
        ref, out["fit_highest_s"] = _highest(
            torch, lambda: LogisticRegression(**FIT), X_train, y_train)
        _, out["beta_rel_err_vs_highest"] = rel_err(beta_k,
                                                    _beta_of(torch, ref))
        assert out["beta_rel_err_vs_highest"] <= BETA_REL, out
        _, out["beta_rel_err_vs_planted"] = rel_err(beta_k[:d], bt)

        # K1, K2 and K3 at this path's shapes, K3 on X staged as the fit
        # stages it, at half the fitted beta (at the optimum g is rounding
        # noise, which no relative tolerance holds).
        xa = torch.cat([X_train.data,
                        torch.ones(split, 1, device=DEVICE)], dim=1)
        out["kernels"] = _kernels_at(
            torch, X_train.data, xa, y_train.data, 0.5 * beta_k,
            staged=cuda_newton.prepare(xa))
        del xa, G, ref, model

        # Device seconds of the pipeline's kernels over its seconds from
        # the first byte parsed to the second predict.
        pipeline = sum(out[k] for k in (
            "parse_s", "host_to_device_s", "gram_s", "fit_s",
            "predict_cold_s", "predict_warm_s"))
        out["pipeline_s"] = pipeline
        out["pipeline_kernel_share"] = (
            out["kernels"]["gram"]["ms"]
            + FIT["max_iter"] * out["kernels"]["newton_stats"]["ms"]
        ) / 1e3 / pipeline

        rows = -(-(n - split) // HIGGS_BLOCKS)
        Xb = X_test.reshape(block_shape=(rows, d))
        assert Xb.grid_shape == (HIGGS_BLOCKS, 1), Xb.grid_shape
        out["checkpoint_shape"] = [n - split, d]
        out["checkpoint_blocks"] = HIGGS_BLOCKS
        out.update(_higgs_checkpoints(torch, app, Xb, x_host[split:], root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert not os.path.exists(root), root
    out["max_rss_bytes"] = 1024 * resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------
# Phase 11: the random layer
# ---------------------------------------------------------------------

RANDOM123 = (
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
)
RANDOM_SLICE = 1 << 22       # card vs CPU route: bits, random, integers, normal
RANDOM_DRAWS = 1 << 20       # card vs CPU route: every other distribution
RANDOM_LAW_DRAWS = 1 << 22   # one draw of each distribution against its law
NORMAL_ULPS = 4
# Card vs the CPU route, |got - ref| <= rtol*|ref| + atol*max|ref| on all
# but ``frac`` of the elements. "exact": equal. "ulp": one transcendental
# of the card's math library against the host's on an exact uniform; the
# few elements let off sit where the function magnifies an ulp of its
# argument (tan at its pole, a difference of logs near 0). "looped": an
# accept test or a floor on such a value may flip. "law": see
# ``negative_binomial`` in ROADMAP Queue C.
RANDOM_CLASSES = {
    "exact": (0.0, 0.0, 0.0),
    "ulp": (1e-5, 1e-6, 1e-4),
    "looped": (1e-5, 1e-5, 1e-3),
}
# (distribution, parameters, class, law check on float64 draws)
RANDOM_DISTS = [
    ("random", (), "exact", lambda s: (0 <= s).all() and (s < 1).all()
     and abs(s.mean() - 0.5) < 1e-3 and abs(s.var() - 1 / 12) < 1e-3),
    ("uniform", (-2.0, 3.5), "ulp", lambda s: (-2 <= s).all()
     and (s < 3.5).all() and abs(s.mean() - 0.75) < 5e-3),
    ("normal", (1.0, 2.0), "ulp", lambda s: abs(s.mean() - 1.0) < 6e-3
     and abs(s.var() - 4.0) < 3e-2),
    ("beta", (2.0, 3.0), "looped", lambda s: ((0 < s) & (s < 1)).all()
     and abs(s.mean() - 0.4) < 1e-3),
    ("binomial", (10.0, 0.5), "looped", lambda s: ((0 <= s) & (s <= 10)).all()
     and abs(s.mean() - 5.0) < 1e-2),
    ("binomial", (200.0, 0.4), "looped", lambda s: ((0 <= s) & (s <= 200)).all()
     and abs(s.mean() - 80.0) < 5e-2),
    ("chisquare", (4.0,), "looped", lambda s: (s > 0).all()
     and abs(s.mean() - 4.0) < 2e-2),
    ("exponential", (2.0,), "ulp", lambda s: (s >= 0).all()
     and abs(s.mean() - 2.0) < 1e-2),
    ("f", (5.0, 7.0), "looped", lambda s: (s > 0).all()
     and abs(np.median(s) - 0.9) < 0.1),
    ("gamma", (2.0, 2.0), "looped", lambda s: (s > 0).all()
     and abs(s.mean() - 4.0) < 2e-2),
    ("gamma", (0.3, 1.0), "looped", lambda s: (s >= 0).all()
     and abs(s.mean() - 0.3) < 5e-3),
    # a uniform of exactly 0 (2^-23 of the float32 draws) gives the int32
    # maximum, in the reference too: the mean is taken below it
    ("geometric", (0.5,), "looped", lambda s: (s >= 1).all()
     and np.median(s) <= 2.0 and (s > 1e6).mean() < 1e-5
     and abs(s[s < 1e6].mean() - 2.0) < 1e-2),
    ("gumbel", (0.0, 1.0), "ulp", lambda s: np.isfinite(s).all()
     and abs(s.mean() - 0.5772) < 1e-2),
    ("laplace", (0.0, 1.0), "ulp", lambda s: abs(s.mean()) < 1e-2
     and abs(s.var() - 2.0) < 5e-2),
    ("logistic", (0.0, 1.0), "ulp", lambda s: abs(s.mean()) < 1e-2),
    ("lognormal", (0.0, 0.5), "ulp", lambda s: (s > 0).all()
     and abs(s.mean() - np.exp(0.125)) < 5e-3),
    ("pareto", (3.0,), "ulp", lambda s: (s >= 0).all()
     and abs(s.mean() - 0.5) < 1e-2),
    ("poisson", (3.0,), "looped", lambda s: (s >= 0).all()
     and abs(s.mean() - 3.0) < 1e-2),
    ("poisson", (50.0,), "looped", lambda s: (s >= 0).all()
     and abs(s.mean() - 50.0) < 5e-2),
    ("power", (3.0,), "ulp", lambda s: ((0 <= s) & (s <= 1)).all()
     and abs(s.mean() - 0.75) < 1e-3),
    # likewise log(0): an infinite draw, in the reference too
    ("rayleigh", (1.0,), "ulp", lambda s: (s >= 0).all()
     and np.isinf(s).mean() < 1e-5
     and abs(s[np.isfinite(s)].mean() - np.sqrt(np.pi / 2)) < 5e-3),
    ("standard_cauchy", (), "ulp", lambda s: np.isfinite(s).all()
     and abs(np.median(s)) < 1e-2),
    ("standard_t", (5.0,), "looped", lambda s: abs(np.median(s)) < 1e-2),
    ("triangular", (0.0, 0.5, 1.0), "ulp", lambda s: ((0 <= s) & (s <= 1)).all()
     and abs(s.mean() - 0.5) < 1e-3),
    ("wald", (1.0, 1.0), "looped", lambda s: (s > 0).all()
     and abs(s.mean() - 1.0) < 1e-2),
    ("weibull", (2.0,), "ulp", lambda s: (s >= 0).all()
     and abs(s.mean() - 0.8862) < 5e-3),
    ("negative_binomial", (5.0, 0.5), "law", lambda s: (s >= 0).all()
     and abs(s.mean() - 5.0) < 2e-2 and abs(s.var() - 10.0) < 0.2),
    ("noncentral_chisquare", (4.0, 2.0), "looped", lambda s: (s > 0).all()
     and abs(s.mean() - 6.0) < 3e-2),
    ("noncentral_chisquare", (0.5, 1.0), "looped", lambda s: (s >= 0).all()
     and abs(s.mean() - 1.5) < 2e-2),
    ("noncentral_f", (5.0, 20.0, 3.0), "looped", lambda s: (s > 0).all()
     and abs(s.mean() - 20.0 / 18.0 * 8.0 / 5.0) < 2e-2),
    # float32's pi is just above pi
    ("vonmises", (0.0, 1.0), "angle", lambda s: (
        np.abs(s) <= float(np.float32(np.pi))).all()
     and abs(s.mean()) < 1e-2),
    ("zipf", (3.0,), "looped", lambda s: (s >= 1).all()
     and abs(np.median(s) - 1.0) < 1e-9),
    ("logseries", (0.5,), "looped", lambda s: (s >= 1).all()
     and abs(s.mean() - 0.5 / (0.5 * np.log(2.0))) < 1e-2),
]


def _mismatch(torch, got, ref, rtol, atol):
    """(fraction of elements outside rtol*|ref| + atol*max|ref|, the
    largest |got - ref| / max|ref|), both as float64 on the host."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = max(float(ref.abs().max()), 1e-30)
    err = (got - ref).abs()
    ok = (err <= rtol * ref.abs() + atol * scale) | (got == ref)
    return 1.0 - float(ok.double().mean()), float(err.max()) / scale


def _held(torch, cls, got, ref, mu=0.0):
    """The check of one distribution's card draw against the CPU route's:
    (passed, {"mismatch": fraction, "max_err_over_max": x})."""
    if cls == "angle":
        # vonmises: arccos near 1 magnifies an ulp of its argument without
        # bound, so the class's tolerance is on the cosine of the angle
        # from mu, and the angle itself is held to 1e-3.
        rtol, atol, frac = RANDOM_CLASSES["looped"]
        bad, err = _mismatch(torch, torch.cos(got.double() - mu),
                             torch.cos(ref.double() - mu), rtol, atol)
        bad_angle, _ = _mismatch(torch, got, ref, 0.0, 1e-3 / np.pi)
        return bad <= frac and bad_angle <= frac, {
            "mismatch": max(bad, bad_angle), "max_err_over_max": err}
    rtol, atol, frac = RANDOM_CLASSES[cls]
    bad, err = _mismatch(torch, got, ref, rtol, atol)
    return bad <= frac, {"mismatch": bad, "max_err_over_max": err}


def phase_random(torch, smi, app, draw):
    """Phase 11 (the module docstring lists its checks). ``draw`` is phase
    4's record of the 2.5M x 1000 draw, None when phase 4 did not run. Any
    breach raises: the run then ends without its last line."""
    from nums_tpu_torch.core.ops import random_ops, threefry
    from nums_tpu_torch.models import model_selection

    t_phase = time.perf_counter()
    out = {"phase": "random", "nvidia_smi": smi, "draw": draw}
    f32, i32 = torch.float32, torch.int32

    # (a) the Random123 vectors, scalar keys and tensor keys
    for key, ctr, want in RANDOM123:
        c = [torch.tensor([threefry._signed(w)], dtype=i32, device=DEVICE)
             for w in ctr]
        k = [torch.tensor([threefry._signed(w)], dtype=i32, device=DEVICE)
             for w in key]
        for k0, k1 in ((key[0], key[1]), (k[0], k[1])):
            w0, w1 = threefry.threefry2x32(k0, k1, c[0], c[1])
            got = (int(w0.item()) & 0xFFFFFFFF, int(w1.item()) & 0xFFFFFFFF)
            assert got == want, ("Random123", key, ctr, got, want)
    out["random123_vectors"] = len(RANDOM123)

    # (b) known answers from the reference
    got = random_known_answers(DEVICE)
    for name in ("bits", "random", "integers", "permutation"):
        assert got[name] == RANDOM_KNOWN[name], (name, got[name])
    gn = np.array(got["normal"])
    kn = np.array(RANDOM_KNOWN["normal"])
    assert (np.abs(gn - kn) <= NORMAL_KNOWN_REL * np.abs(kn)
            + NORMAL_KNOWN_ABS).all(), (gn.tolist(), kn.tolist())
    out["known_answers"] = {
        "positions": len(RANDOM_KNOWN["bits"]),
        "beyond_2_32": len(RANDOM_KNOWN["positions_beyond_2_32"]),
        "normal_max_abs_err": float(np.abs(gn - kn).max())}

    # (c) the card against the package's own CPU route, asked for
    # explicitly: a 2^22 slice that straddles a chunk edge of the full draw
    key = threefry.fold_in(threefry.seed_key(RANDOM_KNOWN["seed"], False), 7)
    shape = (N_FULL, D_FULL)
    start = threefry.CHUNK - RANDOM_SLICE // 2
    at = (start, start + RANDOM_SLICE)
    both = lambda fn: (fn(DEVICE), fn("cpu"))  # noqa: E731
    g, r = both(lambda dev: threefry.random_bits(key, shape, 32, dev, *at))
    assert torch.equal(g.cpu(), r), "bits: card vs cpu"
    g, r = both(lambda dev: random_ops.jr_uniform(
        key, shape, f32, dev, flat_range=at))
    assert torch.equal(g.cpu(), r), "random: card vs cpu"
    g, r = both(lambda dev: random_ops.jr_randint(
        key, shape, 0, 1000, i32, dev, False, flat_range=at))
    assert torch.equal(g.cpu(), r), "integers: card vs cpu"
    g, r = both(lambda dev: random_ops.jr_normal(
        key, shape, f32, dev, flat_range=at))
    ulps = ((g.cpu().double() - r.double()).abs()
            / torch.from_numpy(np.spacing(np.abs(r.numpy()))).double())
    out["normal_card_vs_cpu_max_ulps"] = float(ulps.max())
    assert float(ulps.max()) <= NORMAL_ULPS, float(ulps.max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = random_ops.permutation(key, N_FULL, DEVICE)
    torch.cuda.synchronize()
    out["permutation_seconds"] = time.perf_counter() - t0
    assert torch.equal(perm.cpu(), random_ops.permutation(key, N_FULL, "cpu"))
    # (e) ... which is a permutation, in the two rounds the formula gives
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(N_FULL, device=DEVICE))
    rounds = int(np.ceil(3 * np.log(N_FULL) / np.log(2**32 - 1)))
    assert rounds == 2, rounds
    out["permutation"] = {"n": N_FULL, "sort_rounds": rounds}
    del perm, g, r, ulps

    dists = {}
    n = (RANDOM_DRAWS,)
    for i, (name, params, cls, _) in enumerate(RANDOM_DISTS):
        k = threefry.fold_in(key, 100 + i)
        g, r = both(lambda dev: random_ops.sample(
            name, k, n, f32, dev, False, *params))
        label = f"{name}{list(params)}"
        if cls == "law":
            dists[label] = {"class": cls}
            continue
        ok, info = _held(torch, cls, g, r, mu=params[0] if params else 0.0)
        dists[label] = {"class": cls, **info}
        assert ok, (label, info)
    k = threefry.fold_in(key, 200)
    g, r = both(lambda dev: random_ops.hypergeometric(
        k, n, torch.int64, dev, 10, 20, 10))
    assert torch.equal(g.cpu(), r), "hypergeometric: card vs cpu"
    for replace, p in ((True, None), (False, None), (True, [.1, .2, .3, .4])):
        g, r = both(lambda dev: random_ops.jr_choice(
            k, 4 if p else 5000, (3,) if not replace else (4096,), replace,
            None if p is None else torch.tensor(p, dtype=f32, device=dev),
            dev, False))
        # weighted: a cumulative sum in another order may move a boundary
        ok, info = _held(torch, "looped" if p else "exact", g, r)
        assert ok, ("choice: card vs cpu", replace, p, info)
    out["card_vs_cpu"] = {"slice": RANDOM_SLICE, "draws": RANDOM_DRAWS,
                          "classes": RANDOM_CLASSES, "distributions": dists}
    print(json.dumps({"random_so_far": out}), file=sys.stderr, flush=True)

    # (d) chunk size and block shape change nothing, bitwise
    small = (4099, 257)
    whole = random_ops.jr_normal(key, small, f32, DEVICE)
    for chunk in (1 << 10, 99_991, 1 << 20):
        assert torch.equal(whole, random_ops.jr_normal(
            key, small, f32, DEVICE, chunk=chunk)), ("chunk", chunk)
    ints = random_ops.jr_randint(key, small, -5, 1000, i32, DEVICE, False)
    assert torch.equal(ints, random_ops.jr_randint(
        key, small, -5, 1000, i32, DEVICE, False, chunk=77_777))
    arrays = [app.random_state(5).normal(
        shape=small, block_shape=bs, dtype=np.float32).data
        for bs in (small, (1000, 64), (1, 1))]
    assert torch.equal(arrays[0], arrays[1])
    assert torch.equal(arrays[0], arrays[2])
    del whole, ints, arrays

    # (f) one draw of each distribution against its law, through the
    # random state (so the dtype mapping of a float64 request is in it)
    rs = app.random_state(20260)
    laws = {}
    for name, params, _, law in RANDOM_DISTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arr = getattr(rs, name)(*params, shape=(RANDOM_LAW_DRAWS,))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert arr.data.dtype == f32, (name, arr.dtype)
        assert arr.data.device.type == DEVICE, (name, arr.data.device)
        sample = arr.get().astype(np.float64)
        laws[f"{name}{list(params)}"] = {
            "seconds": secs, "mean": float(sample.mean())}
        assert bool(law(sample)), (name, params, float(sample.mean()),
                                   float(sample.var()))
    h = rs.hypergeometric(20, 10, 10, shape=(RANDOM_LAW_DRAWS,)).get()
    assert h.dtype == np.int64 and ((0 <= h) & (h <= 10)).all()
    assert abs(h.mean() - 10 * 20 / 30) < 1e-2, h.mean()
    out["laws"] = {"draws": RANDOM_LAW_DRAWS, "distributions": laws}

    # (g) a saved state resumes the stream bitwise; a shuffled split of
    # 2.5M rows partitions them
    state = rs.get_state()
    first = rs.normal(shape=(1 << 16,), dtype=np.float32).data
    other = app.random_state(1)
    other.set_state(state)
    assert torch.equal(first, other.normal(shape=(1 << 16,),
                                           dtype=np.float32).data)
    rows = app.array(np.arange(N_FULL, dtype=np.float32).reshape(-1, 1),
                     block_shape=(N_FULL, 1))
    label = app.array(np.arange(N_FULL, dtype=np.float32),
                      block_shape=(N_FULL,))
    parts = model_selection.train_test_split(rows, label, test_size=0.2,
                                             random_state=3)
    x_train, x_test, y_train, y_test = (p.data for p in parts)
    assert x_train.shape[0] == 2_000_000 and x_test.shape[0] == 500_000
    assert torch.equal(x_train[:, 0], y_train)
    assert torch.equal(x_test[:, 0], y_test)
    union = torch.sort(torch.cat([y_train, y_test])).values
    assert torch.equal(union, torch.arange(
        N_FULL, dtype=torch.float32, device=DEVICE))
    assert not torch.equal(y_train, torch.arange(
        2_000_000, dtype=torch.float32, device=DEVICE))
    out["train_test_split_rows"] = N_FULL
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


FACADE_COLS = 8              # the statistics' columns: 2.5M x 8 = 20M values
FACADE_HOST_ROWS = 30_000    # the row slice copied to the host for indexing
FACADE_POINTS = 1 << 20      # the pointwise gather X[rows, cols]
FACADE_UFUNC_N = 1 << 20     # each ufunc, card vs the CPU route
FACADE_ULPS = 4              # transcendental ufuncs, card vs CPU
FACADE_RED_REL = 1e-5        # column sum/mean/var/std vs float64, of max|ref|
FACADE_SCAN_REL = FULL_REL   # float32 cumsum of 2.5M rows vs float64
FACADE_LA_SHAPE = (1 << 20, 128)
FACADE_SQ = 1000             # the square matrices of det/inv/solve/eig(h)
FACADE_LA_REL = 1e-4         # float32 linalg vs float64 numpy, of max|ref|
FACADE_DET_REL = 1e-3        # det: a product of 1000 float32 pivots
# The forms of the facade whose contraction is X.T @ X; each must launch
# K1 once (nums_tpu's reach its Pallas gram).
FACADE_GRAM_FORMS = (
    ("matmul_operator", lambda nps, X: X.T @ X),
    ("nps_matmul", lambda nps, X: nps.matmul(X.T, X)),
    ("nps_dot", lambda nps, X: nps.dot(X.T, X)),
    ("nps_tensordot", lambda nps, X: nps.tensordot(X.T, X, axes=1)),
    ("method_dot", lambda nps, X: X.T.dot(X)),
    ("linalg_matmul", lambda nps, X: nps.linalg.matmul(X.T, X)),
    ("linalg_multi_dot", lambda nps, X: nps.linalg.multi_dot([X.T, X])),
    ("nps_transpose", lambda nps, X: nps.matmul(nps.transpose(X), X)),
)
# Ufuncs whose float results must equal the CPU route's: comparisons,
# rounding, signs and magnitudes, selections; every other float result
# may differ by rounding (the card's division, square root and
# transcendental functions are not the host's), and every integer result
# must be equal. The division family computes jax's divmod from the exact
# ``fmod``: a last-ulp difference of the card's division cannot move it.
FACADE_EXACT = {
    "abs", "absolute", "fabs", "negative", "positive", "sign", "signbit",
    "ceil", "floor", "trunc", "rint", "conj", "conjugate", "isfinite",
    "isinf", "isnan", "logical_not", "equal", "not_equal", "greater",
    "greater_equal", "less", "less_equal", "logical_and", "logical_or",
    "logical_xor", "maximum", "minimum", "fmax", "fmin", "copysign",
    "nextafter", "heaviside", "fmod", "mod", "remainder", "floor_divide",
}


def _ulps(got, ref, scale=None):
    """Each finite element's error in float32 ulps of its magnitude: of
    ``ref``, or of ``scale`` where that is larger (a binary op's
    operands: ``logaddexp`` near 0 is the difference of two terms of their
    size)."""
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    mag = np.abs(ref[fin]).astype(np.float32)
    if scale is not None:
        mag = np.maximum(mag, np.asarray(scale, dtype=np.float32)[fin])
    return (np.abs(got[fin].astype(np.float64) - ref[fin].astype(np.float64))
            / np.spacing(mag).astype(np.float64))


def _within_ulps(got, ref, ulps, scale=None):
    """NaN where ref is NaN, ±inf where it is, elsewhere within ``ulps``
    float32 ulps (``_ulps``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if not np.array_equal(np.isnan(got), np.isnan(ref)):
        return False
    inf = np.isinf(ref)
    if not np.array_equal(got[inf], ref[inf]):
        return False
    return bool(np.all(_ulps(got, ref, scale) <= ulps))


def _col_stats64(torch, x, chunk=1 << 18):
    """Per-column float64 sum, sum of squares, min, max and first argmax
    of ``x``, a row chunk at a time."""
    d = x.shape[1]
    s = torch.zeros(d, dtype=torch.float64, device=x.device)
    sq = torch.zeros_like(s)
    mn = torch.full_like(s, float("inf"))
    mx = torch.full_like(s, float("-inf"))
    arg = torch.zeros(d, dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        s += c.sum(0)
        sq += (c * c).sum(0)
        mn = torch.minimum(mn, c.amin(0))
        cmax, carg = c.max(0)
        arg = torch.where(cmax > mx, carg + i, arg)
        mx = torch.maximum(mx, cmax)
    return s, sq, mn, mx, arg


def _facade_ufuncs(torch, nps, app, cpu_app):
    """Every ufunc of ``numpy/api.py`` on the card against the port's own
    CPU route (``map_uop``/``map_bop`` of an application on the CPU, in the
    card's dtype mode), at 2^20 elements in float32 and int32: the same
    dtype and exception, and equal values for every integer result and the
    float ops of ``FACADE_EXACT``, the other float results within
    ``FACADE_ULPS``. Every mismatch is listed before the check fails."""
    from nums_tpu_torch.numpy import api

    rng = np.random.default_rng(RANDOM_KNOWN["seed"])
    n = FACADE_UFUNC_N
    inputs = {
        "float32": (rng.standard_normal(n).astype(np.float32) * 3,
                    rng.standard_normal(n).astype(np.float32) * 3),
        "int32": (rng.integers(-50, 51, n).astype(np.int32),
                  rng.integers(1, 9, n).astype(np.int32)),
    }

    def run(fn):
        try:
            out = fn()
            return out.get(), None
        except (TypeError, ValueError) as e:
            return None, type(e)

    checked, exact, within, raised = 0, 0, 0, 0
    ulps, bad = {}, []
    for dtype, (x, y) in inputs.items():
        xc, yc = app.array(x), app.array(y)
        xh, yh = cpu_app.array(x), cpu_app.array(y)
        for name in api.UOP_NAMES + api.BOP_NAMES:
            if name in api.BOP_NAMES:
                got = run(lambda: getattr(nps, name)(xc, yc))
                ref = run(lambda: cpu_app.map_bop(name, xh, yh))
            else:
                got = run(lambda: getattr(nps, name)(xc))
                ref = run(lambda: cpu_app.map_uop(name, xh))
            checked += 1
            if got[1] is not ref[1]:
                bad.append((name, dtype, "exception", str(got[1]),
                            str(ref[1])))
                continue
            if ref[1] is not None:
                raised += 1
                continue
            g, r = got[0], ref[0]
            if g.dtype != r.dtype or g.shape != r.shape:
                bad.append((name, dtype, "dtype", str(g.dtype),
                            str(r.dtype)))
            elif r.dtype.kind in "biu" or name in FACADE_EXACT:
                exact += 1
                if not np.array_equal(g, r, equal_nan=r.dtype.kind == "f"):
                    bad.append((name, dtype, "not equal"))
            else:
                within += 1
                scale = (np.maximum(np.abs(x), np.abs(y))
                         if name in api.BOP_NAMES else None)
                err = _ulps(g, r, scale)
                ulps[f"{name}_{dtype}"] = float(err.max()) if err.size else 0.0
                if not _within_ulps(g, r, FACADE_ULPS, scale):
                    bad.append((name, dtype, "ulps",
                                ulps[f"{name}_{dtype}"]))
    assert not bad, bad
    worst = max(ulps, key=ulps.get) if ulps else None
    return {"ufuncs": len(api.UOP_NAMES) + len(api.BOP_NAMES),
            "cases": checked, "exact": exact, "within_ulps": within,
            "same_exception": raised, "ulps_limit": FACADE_ULPS,
            "worst_ulps": ulps.get(worst, 0.0), "worst_ulps_op": worst,
            "ulps_by_op": ulps, "elements": n}


def _facade_linalg(torch, nps, app, step):
    """``nps.linalg`` on the card: ``qr``/``svd``/``lstsq``/``norm`` at
    2^20 x 128 bitwise the application's entry points; ``det``/``inv``/
    ``solve``/``eigh``/``eig`` at 1000 x 1000 against float64 numpy."""
    out = {}
    m, k = FACADE_LA_SHAPE
    rs = app.random_state(RANDOM_KNOWN["seed"] + 1)
    A = rs.normal(shape=(m, k), block_shape=(m, k), dtype=np.float32)
    b = rs.normal(shape=(m,), block_shape=(m,), dtype=np.float32)
    a_bytes = 4.0 * m * k
    q, r = step("linalg_qr", lambda: nps.linalg.qr(A), 3 * a_bytes,
                4.0 * m * k * k)
    q2, r2 = app.qr(A)
    assert torch.equal(q.data, q2.data) and torch.equal(r.data, r2.data)
    del q, r, q2, r2
    u, s, vt = step("linalg_svd", lambda: nps.linalg.svd(A), 3 * a_bytes,
                    6.0 * m * k * k)
    u2, s2, vt2 = app.svd(A)
    assert all(torch.equal(p.data, p2.data)
               for p, p2 in ((u, u2), (s, s2), (vt, vt2)))
    del u, s, vt, u2, s2, vt2
    th = step("linalg_lstsq", lambda: nps.linalg.lstsq(A, b),
              a_bytes + 4.0 * m, 4.0 * m * k * k)
    assert torch.equal(th.data, app.lstsq(A, b).data)
    nb = step("linalg_norm", lambda: nps.linalg.norm(b), 4.0 * m, 2.0 * m)
    assert torch.equal(nb.data, app.norm(b).data)
    out["bitwise_as_application"] = ["qr", "svd", "lstsq", "norm"]
    del A, b

    n = FACADE_SQ
    rng = np.random.default_rng(RANDOM_KNOWN["seed"])
    mh = (np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)).astype(
        np.float32)
    sh = ((mh + mh.T) / 2).astype(np.float32)
    vh = rng.standard_normal(n).astype(np.float32)
    M, S, v = app.array(mh), app.array(sh), app.array(vh)
    m64, s64, v64 = (a.astype(np.float64) for a in (mh, sh, vh))
    sq_bytes = 4.0 * n * n

    def rel(got, ref):
        got = np.asarray(got, dtype=np.complex128)
        return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))

    d = step("linalg_det", lambda: nps.linalg.det(M), sq_bytes,
             2.0 / 3 * n ** 3)
    out["det_rel_err"] = abs(float(d) - np.linalg.det(m64)) / abs(
        np.linalg.det(m64))
    inv = step("linalg_inv", lambda: nps.linalg.inv(M), 2 * sq_bytes,
               2.0 * n ** 3)
    out["inv_rel_err"] = rel(inv.get(), np.linalg.inv(m64))
    sol = step("linalg_solve", lambda: nps.linalg.solve(M, v), sq_bytes,
               2.0 / 3 * n ** 3)
    out["solve_rel_err"] = rel(sol.get(), np.linalg.solve(m64, v64))
    w, vecs = step("linalg_eigh", lambda: nps.linalg.eigh(S), 2 * sq_bytes,
                   9.0 * n ** 3)
    out["eigh_rel_err"] = rel(w.get(), np.linalg.eigvalsh(s64))
    vv = vecs.get().astype(np.float64)
    out["eigh_residual"] = float(np.max(np.abs(
        s64 @ vv - vv * w.get())) / np.max(np.abs(s64)))
    we, _ = step("linalg_eig", lambda: nps.linalg.eig(M), 2 * sq_bytes,
                 25.0 * n ** 3)
    w64 = np.linalg.eigvals(m64)
    wg = we.get().astype(np.complex128)
    nearest = np.min(np.abs(w64[:, None] - wg[None, :]), axis=1)
    out["eig_rel_err"] = float(nearest.max() / np.max(np.abs(w64)))
    out["eig_dtype"] = str(we.dtype)
    out["tolerance_rel"] = FACADE_LA_REL
    out["det_tolerance_rel"] = FACADE_DET_REL
    assert out["det_rel_err"] <= FACADE_DET_REL, out
    for key in ("inv", "solve", "eigh", "eig"):
        assert out[f"{key}_rel_err"] <= FACADE_LA_REL, (key, out)
    assert out["eigh_residual"] <= FACADE_LA_REL, out
    return out


def draw_facade_x(torch, app):
    """Phase 4's X drawn again from its seed (the facade phases' input):
    (X, seconds)."""
    t0 = time.perf_counter()
    X = app.random_state(RANDOM_KNOWN["seed"]).normal(
        shape=(N_FULL, D_FULL), block_shape=(N_FULL, D_FULL),
        dtype=np.float32)
    torch.cuda.synchronize()
    return X, time.perf_counter() - t0


def _stepper(torch, steps):
    """``step(name, fn, bytes_moved, flops=0.0, tc_flops=0.0)``: one facade
    call, recorded in ``steps[name]``: host-clock seconds after a
    synchronize, its bound (``flops`` on the f32 units, ``tc_flops`` on the
    tensor cores), its peak device memory (in all and above what was
    allocated before it) and the kernel launches it made."""
    def step(name, fn, bytes_moved, flops=0.0, tc_flops=0.0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = _counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = _counts()
        bound_ms, bound_by = _bound(bytes_moved, tc_flops, flops)
        steps[name] = {"seconds": secs, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "peak_bytes": peak,
                       "peak_above_base_bytes": peak - base,
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
        return res

    return step


def phase_facade(torch, smi, app, X, draw_seconds):
    """Phase 12 (the module docstring lists its checks). ``X`` is phase
    4's 2.5M x 1000 array (``draw_facade_x``), drawn in ``draw_seconds``.
    Any breach raises: the run then ends without its last line. Returns
    the phase's launch counts (set to 0 just before the facade's path,
    read just after)."""
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core import application_manager, settings

    t_phase = time.perf_counter()
    out = {"phase": "facade", "nvidia_smi": smi, "shape": [N_FULL, D_FULL],
           "draw_seconds": draw_seconds}
    application_manager.set_instance(app)
    x_bytes = 4.0 * N_FULL * D_FULL
    rows_before = X.data[:FACADE_HOST_ROWS].clone()
    steps = {}
    step = _stepper(torch, steps)
    _reset_counts()
    # (a) every contraction form of X.T @ X: K1 once each, bitwise equal
    g_bytes = x_bytes + 4.0 * D_FULL * D_FULL
    first = None
    for name, form in FACADE_GRAM_FORMS:
        G = step(f"gram_{name}", lambda: form(nps, X), g_bytes,
                 tc_flops=_triangle_flops(N_FULL, D_FULL))
        assert steps[f"gram_{name}"]["launches"] == {"gram": 1}, (
            name, steps[f"gram_{name}"])
        if first is None:
            first = G
        else:
            assert torch.equal(G.data, first.data), name
    g64 = _gram64(X.data)
    _, out["gram_rel_err_vs_f64"] = rel_err(first.data, g64)
    assert out["gram_rel_err_vs_f64"] <= BF16_REL, out
    settings.matmul_precision = "highest"
    try:
        Gh = step("gram_highest", lambda: nps.matmul(X.T, X), g_bytes,
                  2.0 * N_FULL * D_FULL * D_FULL)
    finally:
        settings.matmul_precision = "default"
    assert not steps["gram_highest"]["launches"], steps["gram_highest"]
    _, out["gram_highest_rel_err_vs_f64"] = rel_err(Gh.data, g64)
    assert out["gram_highest_rel_err_vs_f64"] <= FULL_REL, out
    del G, first, Gh, g64

    # (b) the mask read X[y > 0], y planted labels; and from host indices
    y = (X[:, 1] > 0.5).astype(np.float32)
    count = int((y.data > 0).sum())
    sel = step("mask_read", lambda: X[y > 0],
               5.0 * N_FULL + 8.0 * count * D_FULL)
    assert sel.shape == (count, D_FULL), (sel.shape, count)
    idx = np.nonzero(y.get() > 0)[0]
    sel2 = step("index_read_host", lambda: X[idx],
                8.0 * count + 8.0 * count * D_FULL)
    assert torch.equal(sel.data, sel2.data)
    out["mask_rows"] = count
    del sel, sel2, y, idx

    # (c) other indexing, full size; bitwise against numpy on a host copy
    # of a row slice
    rng = np.random.default_rng(RANDOM_KNOWN["seed"])
    rows = rng.integers(0, N_FULL, FACADE_POINTS)
    cols = rng.integers(0, D_FULL, FACADE_POINTS)
    keys = {
        "reverse_step3": ((slice(None, None, -3),),
                          8.0 * (-(-N_FULL // 3)) * D_FULL),
        "columns": ((slice(None), [3, 1, 4]), 8.0 * N_FULL * 3),
        "pointwise": ((rows, cols), 16.0 * FACADE_POINTS + 8.0
                      * FACADE_POINTS),
        "newaxis": ((Ellipsis, None), 0.0),
    }
    Xs = X[:FACADE_HOST_ROWS]
    hs = Xs.get()
    for name, (key, nbytes) in keys.items():
        res = step(f"index_{name}", lambda: X[key], nbytes)
        if name == "pointwise":
            assert torch.equal(res.data, X.data[
                torch.from_numpy(rows).to(DEVICE),
                torch.from_numpy(cols).to(DEVICE)])
            key = (rows % FACADE_HOST_ROWS, cols)
        elif name == "reverse_step3":
            assert res.shape == (-(-N_FULL // 3), D_FULL)
            assert torch.equal(res.data[0], X.data[-1])
            assert torch.equal(res.data[-1], X.data[(N_FULL - 1) % 3])
        del res
        assert np.array_equal(Xs[key].get(), hs[key]), name
    out["indexing_checked_rows"] = FACADE_HOST_ROWS
    del Xs, hs

    # (d) assignment on a copy
    Xc = step("copy", lambda: X.copy(), 2 * x_bytes)
    step("setitem_scalar_mask", lambda: Xc.__setitem__(Xc > 3, 3.0),
         2 * x_bytes + N_FULL * D_FULL)
    scalar_peak = steps["setitem_scalar_mask"]["peak_above_base_bytes"]
    mask_bytes = 1.0 * N_FULL * D_FULL
    assert scalar_peak <= x_bytes + mask_bytes + (64 << 20), (
        "setitem's peak above X and its copy", scalar_peak)
    clip = step("clip", lambda: nps.clip(X, None, 3.0), 2 * x_bytes)
    assert torch.equal(Xc.data, clip.data)
    m2 = X < -4.5
    n2 = int(m2.data.sum())
    vals = app.array(np.arange(n2, dtype=np.float32))
    step("setitem_packed_mask", lambda: Xc.__setitem__(m2, vals),
         2 * x_bytes + mask_bytes)
    assert torch.equal(Xc[m2].data, vals.data)
    assert torch.equal(torch.where(m2.data, clip.data, Xc.data), clip.data)
    before = Xc.data[990:2010].cpu().numpy()
    step("setitem_slice", lambda: Xc.__setitem__(
        (slice(1000, 2000), slice(5, 9)), 7.0), 2 * x_bytes)
    want = before.copy()
    want[10:1010, 5:9] = 7.0
    assert np.array_equal(Xc.data[990:2010].cpu().numpy(), want)
    assert torch.equal(X.data[:FACADE_HOST_ROWS], rows_before), (
        "an assignment to the copy wrote into X")
    out["setitem"] = {"scalar_mask_peak_above_base_bytes": scalar_peak,
                      "limit_bytes": x_bytes + mask_bytes,
                      "packed_elements": n2}
    del Xc, clip, m2, vals

    # (e) reductions along axis 0 against float64
    s64, sq64, mn64, mx64, arg64 = _col_stats64(torch, X.data)
    mean64 = s64 / N_FULL
    var64 = sq64 / N_FULL - mean64 * mean64
    checks = {}
    for name, fn, ref in (
            ("sum", lambda: nps.sum(X, axis=0), s64),
            ("mean", lambda: nps.mean(X, axis=0), mean64),
            ("var", lambda: nps.var(X, axis=0), var64),
            ("std", lambda: nps.std(X, axis=0), var64.sqrt())):
        res = step(f"reduce_{name}", fn, x_bytes + 4.0 * D_FULL,
                   2.0 * N_FULL * D_FULL)
        _, checks[name] = rel_err(res.data, ref)
        assert checks[name] <= FACADE_RED_REL, (name, checks[name])
    for name, fn, ref in (
            ("min", lambda: nps.min(X, axis=0), mn64),
            ("max", lambda: nps.max(X, axis=0), mx64),
            ("argmax", lambda: X.argmax(axis=0), arg64)):
        res = step(f"reduce_{name}", fn, x_bytes + 4.0 * D_FULL,
                   1.0 * N_FULL * D_FULL)
        assert torch.equal(res.data.to(ref.dtype), ref), name
    out["reductions_rel_err"] = checks
    out["reductions_tolerance"] = FACADE_RED_REL

    # (f) sorting and statistics on 8 columns (20M values), against numpy
    # on the host copy
    C = X[:, :FACADE_COLS]
    Ct = nps.around(C, 1)          # ties
    hc, ht = C.get(), Ct.get()
    c_bytes = 4.0 * N_FULL * FACADE_COLS
    stats = {}
    res = step("sort", lambda: nps.sort(Ct, axis=0), 2 * c_bytes,
               0.0)
    assert np.array_equal(res.get(), np.sort(ht, axis=0, kind="stable"))
    res = step("argsort", lambda: nps.argsort(Ct, axis=0), 2 * c_bytes)
    assert np.array_equal(res.get(), np.argsort(ht, axis=0, kind="stable"))
    res = step("median", lambda: nps.median(C, axis=0), c_bytes)
    assert _within_ulps(res.get(), np.median(hc, axis=0), 1), "median"
    res = step("percentile", lambda: nps.percentile(C, [1, 50, 99], axis=0),
               c_bytes)
    assert _within_ulps(res.get(), np.percentile(
        hc.astype(np.float64), [1, 50, 99], axis=0).astype(np.float32),
        1), "percentile"
    h, e = step("histogram", lambda: nps.histogram(C, bins=64), c_bytes,
                1.0 * N_FULL * FACADE_COLS * 6)
    he = e.get()
    assert np.array_equal(h.get(), np.histogram(hc, bins=he)[0].astype(
        h.dtype)), "histogram counts"
    # jnp's float32 lerp against numpy's float64 linspace: within 2 ulps of
    # the largest edge (an edge near 0 is the difference of two terms)
    ne = np.histogram_bin_edges(hc, bins=64)
    stats["histogram_edges_max_abs_err"] = float(np.max(np.abs(
        he.astype(np.float64) - ne)))
    assert stats["histogram_edges_max_abs_err"] <= 2 * float(np.spacing(
        np.max(np.abs(ne)).astype(np.float32))), stats
    vals, counts = step("unique", lambda: nps.unique(Ct, return_counts=True),
                        2 * c_bytes)
    uv, uc = np.unique(ht, return_counts=True)
    assert np.array_equal(vals.get(), uv) and np.array_equal(counts.get(),
                                                             uc)
    stats["unique_values"] = int(uv.shape[0])
    ints = nps.astype(nps.abs(Ct) * 10, np.int32)
    res = step("bincount", lambda: nps.bincount(nps.ravel(ints)), c_bytes)
    assert np.array_equal(res.get(), np.bincount(ints.get().ravel()))
    s0 = nps.sort(Ct[:, 0])
    for side in ("left", "right"):
        res = step(f"searchsorted_{side}",
                   lambda: nps.searchsorted(s0, Ct[:, 1], side=side),
                   3 * 4.0 * N_FULL)
        assert np.array_equal(res.get(), np.searchsorted(
            np.sort(ht[:, 0]), ht[:, 1], side=side))
    res = step("cumsum", lambda: nps.cumsum(C, axis=0), 2 * c_bytes,
               1.0 * N_FULL * FACADE_COLS)
    ref = np.cumsum(hc.astype(np.float64), axis=0)
    stats["cumsum_rel_err_vs_f64"] = float(
        np.max(np.abs(res.get() - ref)) / np.max(np.abs(ref)))
    assert stats["cumsum_rel_err_vs_f64"] <= FACADE_SCAN_REL, stats
    stats["cumsum_tolerance"] = FACADE_SCAN_REL
    out["statistics"] = stats
    del C, Ct, hc, ht, res, h, e, vals, counts, ints, s0

    # (g) every ufunc, card vs the CPU route; (h) linalg
    saved = settings.default_float_for
    settings.default_float_for = lambda device: np.dtype(np.float32)
    try:
        cpu_app = application_manager.create(device="cpu")
        out["ufuncs"] = _facade_ufuncs(torch, nps, app, cpu_app)
    finally:
        settings.default_float_for = saved
    out["linalg"] = _facade_linalg(torch, nps, app, step)

    out["launches"] = _counts()
    assert out["launches"]["gram"] == len(FACADE_GRAM_FORMS), out["launches"]
    out["steps"] = steps
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


FT_HOST_ROWS = 30_000        # the row slice copied to the host for numpy
FT_KTH = 10                  # argpartition/partition: the 11 smallest
FT_NAN_SHARE = 0.01          # NaNs planted for nanquantile/nanpercentile
FT_POINTS = 1 << 20          # frexp/modf/i0/sort_complex, casts: card vs CPU
FT_APPLY_ROWS = 100_000      # apply_along_axis
FT_ROOTS_DEGREE = 20
FT_FFT_REL = 1e-5            # float32 FFTs vs float64 numpy / X, of max|ref|
FT_POLYFIT_REL = 1e-4        # float32 polyfit vs float64 numpy, of max|coef|
FT_POLYVAL_REL = 1e-5        # float32 Horner vs float64, of max|ref|
FT_APPLY_REL = 1e-5          # float32 row sums vs float64, of max|ref|
FT_ROOTS_REL = 1e-3          # float32 companion eigenvalues vs float64
FT_ULPS = 4                  # card vs CPU route where not equal (i0)
# The numpy whose surface the CPU tests hold the port's coverage to: on
# that version the report must show no stub; on another, a stub is a name
# that numpy added since, and is named.
COVERAGE_NUMPY = "2.0.2"
COVERAGE_MAX_FALLBACKS = {"numpy": 13, "numpy.random": 1,
                          "numpy.linalg": 2, "numpy.fft": 0}
FT_CAST_SPECIAL = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e20, 2.7,
                            -2.7, 300.5, -129.0], dtype=np.float32)


@contextlib.contextmanager
def _current(app):
    """The package's current application set to ``app`` for a block."""
    from nums_tpu_torch.core import application_manager

    prev = application_manager.instance()
    application_manager.set_instance(app)
    try:
        yield
    finally:
        application_manager.set_instance(prev)


def _equal_or_ulps(got, ref, ulps):
    """("equal" | "ulps", worst ulps): bitwise equal (NaN as NaN), else
    within ``ulps`` float32 ulps of ``ref``; raises AssertionError."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        got.dtype, ref.dtype, got.shape, ref.shape)
    if np.array_equal(got, ref, equal_nan=ref.dtype.kind in "fc"):
        return "equal", 0.0
    assert ref.dtype.kind == "f", ("not equal", ref.dtype)
    assert _within_ulps(got, ref, ulps), float(_ulps(got, ref).max())
    return "ulps", float(_ulps(got, ref).max())


def _coverage(out):
    """The port's coverage report, printed and held: no name missing,
    host fallbacks at most the reference's, and no stub on the numpy the
    CPU tests hold it to (on another numpy each stub is named: a name that
    numpy added)."""
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.cmds import api_coverage

    percents, fallbacks = {}, {}
    report = api_coverage.coverage_report(percents, fallbacks)
    print(report, flush=True)
    stubs = {}
    for name, np_mod, mod in (("numpy", np, nps),
                              ("numpy.random", np.random, nps.random),
                              ("numpy.linalg", np.linalg, nps.linalg),
                              ("numpy.fft", np.fft, nps.fft)):
        _, _, stub, miss = api_coverage._module_coverage(np_mod, mod)
        assert not miss, (name, miss)
        assert fallbacks[name] <= COVERAGE_MAX_FALLBACKS[name], (
            name, fallbacks[name])
        stubs[name] = stub
    out["coverage"] = {"report": report.splitlines(), "numpy": np.__version__,
                       "percent": percents, "fallbacks": fallbacks,
                       "stubs_new_in_this_numpy": stubs}
    if np.__version__ == COVERAGE_NUMPY:
        assert not any(stubs.values()), stubs


def phase_facade_tail(torch, smi, app, X):
    """Phase 13 (the module docstring lists its checks): the facade's
    later modules on phase 12's X. Any breach raises. The kernels' counts
    are set to 0 at the start and must read 0 at the end."""
    from nums_tpu_torch.core import application_manager, settings

    t_phase = time.perf_counter()
    out = {"phase": "facade_tail", "nvidia_smi": smi,
           "shape": [N_FULL, D_FULL]}
    application_manager.set_instance(app)
    rows_before = X.data[:FT_HOST_ROWS].clone()
    steps = {}
    # The CPU route: the package on the host in the card's dtype mode
    # (float32 by default, as on the card) for the whole phase.
    saved = settings.default_float_for
    settings.default_float_for = lambda device: np.dtype(np.float32)
    try:
        cpu_app = application_manager.create(device="cpu")
        _reset_counts()
        _facade_tail_steps(torch, app, cpu_app, X, _stepper(torch, steps),
                           out)
        assert torch.equal(X.data[:FT_HOST_ROWS], rows_before), (
            "X was written")
        out["launches"] = _counts()
        assert not any(out["launches"].values()), out["launches"]
    finally:
        settings.default_float_for = saved
    _coverage(out)
    out["steps"] = steps
    out["peak_bytes"] = max(s["peak_bytes"] for s in steps.values())
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _facade_tail_steps(torch, app, cpu_app, X, step, out):
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core.array.blockarray import BlockArray

    n, d, r = N_FULL, D_FULL, FT_HOST_ROWS
    x_bytes = 4.0 * n * d
    c_bytes = 4.0 * n * FACADE_COLS
    hx = X.data[:r].cpu().numpy()
    x_max = float(X.data.abs().max())
    log2 = np.log2
    rng = np.random.default_rng(RANDOM_KNOWN["seed"])
    checks = {}

    # (a) FFT: rfft of every row and back; fft of 8 columns (length n)
    # rfft and irfft once each to make their cuFFT plans, then timed
    nf = d // 2 + 1
    rf_bytes, rf_flops = x_bytes + 8.0 * n * nf, 2.5 * n * d * log2(d)
    F = step("rfft_first_call", lambda: nps.fft.rfft(X, axis=1), rf_bytes,
             rf_flops)
    del F
    F = step("rfft", lambda: nps.fft.rfft(X, axis=1), rf_bytes, rf_flops)
    assert F.shape == (n, nf) and F.dtype == np.complex64, (F.shape, F.dtype)
    Y = step("irfft_first_call", lambda: nps.fft.irfft(F, n=d, axis=1),
             rf_bytes, rf_flops)
    del Y
    Y = step("irfft", lambda: nps.fft.irfft(F, n=d, axis=1), rf_bytes,
             rf_flops)
    assert Y.shape == (n, d) and Y.dtype == np.float32, (Y.shape, Y.dtype)
    checks["irfft_rfft_rel_err"] = _max_abs_diff(Y.data, X.data) / x_max
    del F, Y
    C = X[:, :FACADE_COLS]
    hc = C.get()
    Fc = step("fft_axis0", lambda: nps.fft.fft(C, axis=0), c_bytes
              + 2 * c_bytes, 5.0 * n * log2(n) * FACADE_COLS)
    ref = np.fft.fft(hc.astype(np.float64), axis=0)
    hf = Fc.get()
    assert hf.dtype == np.complex64, hf.dtype
    checks["fft_axis0_rel_err"] = float(np.max(np.abs(hf - ref))
                                        / np.max(np.abs(ref)))
    del ref
    Fs = step("fftshift", lambda: nps.fft.fftshift(Fc), 4 * c_bytes)
    assert np.array_equal(Fs.get(), np.fft.fftshift(hf)), "fftshift"
    fr = step("fftfreq", lambda: nps.fft.fftfreq(n), 4.0 * n, 1.0 * n)
    assert np.array_equal(fr.get(), np.fft.fftfreq(n).astype(np.float32))
    del Fc, Fs, fr, hf
    for key in ("irfft_rfft_rel_err", "fft_axis0_rel_err"):
        assert checks[key] <= FT_FFT_REL, checks

    # (b) argpartition/partition of every row: the CPU route's on the host
    # rows, the 11 smallest numpy's, and the positions give the values
    k = FT_KTH
    P = step("argpartition", lambda: nps.argpartition(X, k, axis=1),
             2 * x_bytes)
    Q = step("partition", lambda: nps.partition(X, k, axis=1), 2 * x_bytes)
    with _current(cpu_app):
        hp = nps.argpartition(cpu_app.array(hx), k, axis=1).get()
        hq = nps.partition(cpu_app.array(hx), k, axis=1).get()
    assert np.array_equal(P.data[:r].cpu().numpy(), hp), "argpartition"
    assert np.array_equal(Q.data[:r].cpu().numpy(), hq), "partition"
    assert np.array_equal(hq[:, :k + 1], np.sort(hx, axis=1)[:, :k + 1])
    assert torch.equal(torch.gather(X.data, 1, P.data[:, :k + 1].long()),
                       Q.data[:, :k + 1]), "positions and values"
    del P, Q, hp, hq

    # (c) take_along_axis(argsort) is sort; lexsort of three columns
    idx = nps.argsort(C, axis=0)
    T = step("take_along_axis", lambda: nps.take_along_axis(C, idx, axis=0),
             3 * c_bytes)
    S = step("sort", lambda: nps.sort(C, axis=0), 2 * c_bytes)
    assert torch.equal(T.data, S.data), "take_along_axis(argsort) != sort"
    del idx, T, S
    keys = [nps.around(C[:, 0], 1), nps.around(C[:, 1], 1), C[:, 2] > 0]
    hk = [kk.get() for kk in keys]
    L = step("lexsort", lambda: nps.lexsort(keys), 4.0 * n * 3 + 4.0 * n)
    assert np.array_equal(L.get(), np.lexsort(hk)), "lexsort"
    del keys, hk, L

    # (d) nanquantile/nanpercentile with 1% NaN, to 1 ulp of float64 numpy
    hn = hc.copy()
    hn[rng.random(hn.shape) < FT_NAN_SHARE] = np.nan
    Cn = app.array(hn)
    h64 = hn.astype(np.float64)
    for name, fn, q in (("nanquantile", nps.nanquantile, [0.01, 0.5, 0.99]),
                        ("nanpercentile", nps.nanpercentile, [1, 50, 99])):
        res = step(name, lambda: fn(Cn, q, axis=0), c_bytes)
        want = getattr(np, name)(h64, q, axis=0).astype(np.float32)
        assert _within_ulps(res.get(), want, 1), name
    res = step("nancumsum", lambda: nps.nancumsum(Cn, axis=0), 2 * c_bytes,
               1.0 * n * FACADE_COLS)
    assert res.shape == (n, FACADE_COLS)
    del Cn, h64, res

    # (e) membership, set operations and unique_* on 20M int32 values
    ints = (C * 10).astype(np.int32)
    hi = ints.get()
    test = hi[:1000, 0]
    tt = app.array(test)
    i_bytes = 4.0 * n * FACADE_COLS
    res = step("isin", lambda: nps.isin(ints, tt), i_bytes + n * FACADE_COLS)
    assert np.array_equal(res.get(), np.isin(hi, test)), "isin"
    res = step("in1d", lambda: nps.in1d(ints, tt), i_bytes + n * FACADE_COLS)
    assert np.array_equal(res.get(), np.isin(hi.ravel(), test)), "in1d"
    a0, a1 = ints[:, 0], ints[:, 1]
    for name in ("intersect1d", "setdiff1d", "setxor1d", "union1d"):
        res = step(name, lambda: getattr(nps, name)(a0, a1), 8.0 * n)
        assert np.array_equal(res.get(), getattr(np, name)(
            hi[:, 0], hi[:, 1])), name
    ua = np.unique_all(hi)
    fields = {"unique_values": [ua.values],
              "unique_counts": [ua.values, ua.counts],
              "unique_inverse": [ua.values, ua.inverse_indices],
              "unique_all": list(ua)}
    for name, want in fields.items():
        res = step(name, lambda: getattr(nps, name)(ints), 2 * i_bytes)
        got = [res] if name == "unique_values" else list(res)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            g = g.get()
            assert g.shape == w.shape and np.array_equal(g, w), name
    checks["distinct_ints"] = int(ua.values.shape[0])
    del ints, tt, a0, a1, res, ua

    # (f) histogram2d (64 bins) and histogramdd (3 columns, 16 bins):
    # numpy's counts on the port's edges
    H, ex, ey = step("histogram2d", lambda: nps.histogram2d(
        C[:, 0], C[:, 1], bins=64), 8.0 * n, 2.0 * n * 7)
    want = np.histogram2d(hc[:, 0], hc[:, 1], bins=[ex.get(), ey.get()])[0]
    assert np.array_equal(H.get(), want), "histogram2d"
    C3 = C[:, :3]
    H, edges = step("histogramdd", lambda: nps.histogramdd(C3, bins=16),
                    12.0 * n, 3.0 * n * 5)
    want = np.histogramdd(hc[:, :3], bins=[e.get() for e in edges])[0]
    assert np.array_equal(H.get(), want), "histogramdd"
    del H, ex, ey, edges, C3, want

    # (g) polyval and polyfit (degree 3) on 2.5M points
    p_true = np.array([0.5, -1.0, 2.0, 3.0], dtype=np.float32)
    xs = C[:, 0]
    yv = step("polyval", lambda: nps.polyval(app.array(p_true), xs), 8.0 * n,
              6.0 * n)
    want = np.polyval(p_true.astype(np.float64), hc[:, 0].astype(np.float64))
    checks["polyval_rel_err"] = float(np.max(np.abs(yv.get() - want))
                                      / np.max(np.abs(want)))
    y = yv + C[:, 1] * np.float32(0.1)
    coef = step("polyfit", lambda: nps.polyfit(xs, y, 3), 8.0 * n,
                2.0 * n * 16 + 2.0 * n * 4)
    want = np.polyfit(hc[:, 0].astype(np.float64),
                      y.get().astype(np.float64), 3)
    checks["polyfit_rel_err"] = float(np.max(np.abs(coef.get() - want))
                                      / np.max(np.abs(want)))
    checks["polyfit_coefficients"] = coef.get().tolist()
    assert checks["polyval_rel_err"] <= FT_POLYVAL_REL, checks
    assert checks["polyfit_rel_err"] <= FT_POLYFIT_REL, checks
    del xs, yv, y, coef, want

    # (h) the mutators on a copy: putmask is clip; put_along_axis,
    # fill_diagonal and copyto exact (numpy's on the host rows)
    Xc = step("copy", lambda: X.copy(), 2 * x_bytes)
    m = Xc > 3
    step("putmask", lambda: nps.putmask(Xc, m, 3.0), 2 * x_bytes + n * d)
    del m
    clip = step("clip", lambda: nps.clip(X, None, 3.0), 2 * x_bytes)
    assert torch.equal(Xc.data, clip.data), "putmask != clip"
    del clip
    want = Xc.data[:r].cpu().numpy()
    am = nps.expand_dims(X.argmax(axis=1), 1)
    step("put_along_axis", lambda: nps.put_along_axis(Xc, am, -7.0, axis=1),
         2 * x_bytes + 8.0 * n)
    np.put_along_axis(want, am.data[:r].cpu().numpy(), -7.0, axis=1)
    assert np.array_equal(Xc.data[:r].cpu().numpy(), want), "put_along_axis"
    assert bool((torch.gather(Xc.data, 1, am.data.long()) == -7.0).all())
    step("fill_diagonal", lambda: nps.fill_diagonal(Xc, 5.0), 2 * x_bytes)
    np.fill_diagonal(want, 5.0)
    assert np.array_equal(Xc.data[:r].cpu().numpy(), want), "fill_diagonal"
    assert bool((Xc.data[r:] == X.data[r:]).logical_or(
        Xc.data[r:] == -7.0).logical_or(X.data[r:] > 3).all())
    step("copyto", lambda: nps.copyto(Xc, X), 2 * x_bytes)
    assert torch.equal(Xc.data, X.data), "copyto"
    del Xc, am, want

    # (i) packbits and back, bitwise; bitwise_count of X's bits as int32
    B = X > 0
    Pk = step("packbits", lambda: nps.packbits(B, axis=1),
              1.0 * n * d + n * d / 8)
    assert np.array_equal(Pk.data[:r].cpu().numpy(),
                          np.packbits(hx > 0, axis=1)), "packbits"
    U = step("unpackbits", lambda: nps.unpackbits(Pk, axis=1),
             n * d / 8 + 1.0 * n * d)
    assert torch.equal(U.data, B.data.to(torch.uint8)), "unpackbits"
    del B, Pk, U
    Xi = BlockArray.from_torch(X.data.view(torch.int32), backend=app.backend)
    bc = step("bitwise_count", lambda: nps.bitwise_count(Xi),
              x_bytes + 1.0 * n * d, 12.0 * n * d)
    with _current(cpu_app):
        want = nps.bitwise_count(cpu_app.array(hx.view(np.int32))).get()
    assert np.array_equal(bc.data[:r].cpu().numpy(), want), "bitwise_count"
    if hasattr(np, "bitwise_count"):
        assert np.array_equal(want, np.bitwise_count(hx.view(np.int32)))
    del Xi, bc, want

    # (j) at 2^20, card against the CPU route: frexp, modf, i0,
    # sort_complex, and every float-to-integer cast
    v = rng.standard_normal(FT_POINTS).astype(np.float32) * 30
    v[:FT_CAST_SPECIAL.size] = FT_CAST_SPECIAL
    v[FT_CAST_SPECIAL.size:2000] *= 1e8
    pairs = np.round(v.reshape(-1, 2), 0)
    zc = np.empty(pairs.shape[0], dtype=np.complex64)
    zc.real, zc.imag = pairs[:, 0], pairs[:, 1]
    against = {}
    step("i0_first_call", lambda: nps.i0(app.array(v)), 8.0 * v.size)
    for name, fn, arg, nbytes in (
            ("frexp", nps.frexp, v, 12.0 * v.size),
            ("modf", nps.modf, v, 12.0 * v.size),
            ("i0", nps.i0, v, 8.0 * v.size),
            ("sort_complex", nps.sort_complex, zc, 16.0 * zc.size)):
        res = step(name, lambda: fn(app.array(arg)), nbytes)
        with _current(cpu_app):
            ref = fn(cpu_app.array(arg))
        res = res if isinstance(res, tuple) else (res,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        against[name] = [_equal_or_ulps(g.get(), w.get(), FT_ULPS)
                         for g, w in zip(res, ref)]
    for dt in ("int8", "int16", "int32", "int64", "uint8"):
        got = app.array(v).astype(dt).get()
        with _current(cpu_app):
            want = cpu_app.array(v).astype(dt).get()
        assert got.dtype == want.dtype and np.array_equal(got, want), dt
        against[f"astype_{dt}"] = "equal"
    out["card_vs_cpu_route"] = against

    # (k) roots (degree 20), apply_along_axis, select and piecewise
    p = rng.standard_normal(FT_ROOTS_DEGREE + 1).astype(np.float32)
    rts = step("roots", lambda: nps.roots(app.array(p)), 0.0)
    with _current(cpu_app):
        rc = nps.roots(cpu_app.array(p)).get()
    hr = rts.get()
    assert hr.dtype == rc.dtype and np.array_equal(hr, rc), "roots"
    r64 = np.roots(p.astype(np.float64))
    near = np.min(np.abs(r64[:, None] - hr[None, :].astype(np.complex128)),
                  axis=1)
    checks["roots_rel_err"] = float(near.max() / np.max(np.abs(r64)))
    assert checks["roots_rel_err"] <= FT_ROOTS_REL, checks
    A = X[:FT_APPLY_ROWS]
    res = step("apply_along_axis", lambda: nps.apply_along_axis(
        lambda row: (row * row).sum(), 1, A), 4.0 * FT_APPLY_ROWS * d,
        2.0 * FT_APPLY_ROWS * d)
    want = np.square(A.get().astype(np.float64)).sum(axis=1)
    checks["apply_along_axis_rel_err"] = float(
        np.max(np.abs(res.get() - want)) / np.max(np.abs(want)))
    assert checks["apply_along_axis_rel_err"] <= FT_APPLY_REL, checks
    del A, res, want
    m1, m2 = X > 1, X < -1
    nX = -X
    S = step("select", lambda: nps.select([m1, m2], [X, nX], 0.0),
             3 * x_bytes + 2.0 * n * d)
    del nX

    def plain(i):
        """Rows i.. of X and its masks: jnp's definitions of both calls."""
        xc = X.data[i:i + (1 << 18)]
        c1, c2 = m1.data[i:i + (1 << 18)], m2.data[i:i + (1 << 18)]
        return (torch.where(c1, xc, torch.where(c2, -xc,
                                                torch.zeros_like(xc))),
                torch.where(c2, -xc, torch.where(c1, xc * 0.5, xc * 2.0)))

    for i in range(0, n, 1 << 18):
        assert torch.equal(S.data[i:i + (1 << 18)], plain(i)[0]), ("select",
                                                                   i)
    del S
    W = step("piecewise", lambda: nps.piecewise(
        X, [m1, m2], [lambda t: t * 0.5, lambda t: -t, lambda t: t * 2.0]),
        2 * x_bytes + 2.0 * n * d, 3.0 * n * d)
    for i in range(0, n, 1 << 18):
        assert torch.equal(W.data[i:i + (1 << 18)], plain(i)[1]), (
            "piecewise", i)
    del W, m1, m2
    out["checks"] = checks
    out["tolerances"] = {"fft_rel": FT_FFT_REL, "polyfit_rel": FT_POLYFIT_REL,
                         "polyval_rel": FT_POLYVAL_REL,
                         "apply_rel": FT_APPLY_REL,
                         "roots_rel": FT_ROOTS_REL, "ulps": FT_ULPS,
                         "quantile_ulps": 1}


# Phase 14: the models beside the GLMs. The GBDT runs at
# scripts/benchmark_models.py's default (1,000,000 x 28, its iota sin/cos
# generator and label); KMeans, autodiff and optimize on phase 4's X,
# 2.5M x 1000 fp32, not cut.
GBDT_N, GBDT_D = 1_000_000, 28
GBDT = dict(n_estimators=20, max_depth=4, n_bins=64, learning_rate=0.3)
GBDT_ACC = 0.8               # the reference's own assert (benchmark_models)
GBDT_CPU_ROWS = 100_000      # card vs the CPU route
GBDT_LEAF_REL = 1e-5         # leaf values, card vs CPU route, of max|ref|
PROBA_SUM_ABS = 1e-6         # OvR predict_proba rows vs 1
KM_K, KM_SEED = 16, 0
KM_DATA_SEED = 1414          # the planted centers and partition (numpy)
# Planted centers N(0, 100^2): |ci - cj|^2 ~ 2e7, 1e4 times a cluster's own
# squared distances (~2000), so that k-means++ seeds every cluster (a
# draw in a seeded cluster wins the Gumbel max with odds about 1e-4 to 1).
KM_CENTER_SCALE = 100.0
KM_REL = 1e-5                # centers and inertia vs float64 Lloyd's
# jax.random.randint(jax.random.fold_in(jax.random.key(0), 0), (), 0,
# 2_500_000) with x64 off (the card's mode): the first k-means++ row.
KM_FIRST_INDEX = 423887
KM_OOC_ITER = 2              # phase 8: two passes, tol 0
KM_OOC_REL = 1e-4            # phase 8: streamed centers vs in-core Lloyd's
AD_REL = 1e-4                # value_and_grad and hvp vs float64, of max|ref|
GRAM_GRAD_ROWS = 4096
GRAM_GRAD_REL = 1e-5         # K1's fp32 backward vs float64 X(W+W^T)
OPT = dict(method="adam", learning_rate=0.01, steps=100, tol=0.0)
OPT_X_ABS = 1e-6             # eager vs fused minimize
MODELS_LIMIT_S = 90.0


def draw_labels(torch, app, X):
    """Phase 4's labels: its beta and u, drawn after X on X's stream
    (resumed at the counter the X draw leaves), y = (σ(Xβ) > u)."""
    return planted_labels(torch, app, X)[0]


def planted_labels(torch, app, X):
    """(``draw_labels``' y, the planted β) for X of any shape drawn from
    phase 4's seed."""
    n, d = X.shape
    rs = app.random_state(RANDOM_KNOWN["seed"])
    state = rs.get_state()
    state["counter"] = RANDOM_KNOWN["counter"]
    rs.set_state(state)
    beta_true = rs.normal(scale=0.1, shape=(d,), dtype=np.float32)
    u = rs.uniform(shape=(n,), dtype=np.float32)
    eta = X @ beta_true
    y = (app.one / (app.one + app.exp(-eta)) > u).astype(np.float32)
    return y, beta_true


def _gbdt_data(torch, n, d):
    """benchmark_models.py's GBDT data: X = sin(7e-4·i + 0.7·j) +
    0.5·cos(1.3e-3·i) over the float32 iotas, the score sin(3·x0) +
    x5·x11, y = score > 0.2."""
    i = torch.arange(n, dtype=torch.float32, device=DEVICE)[:, None]
    j = torch.arange(d, dtype=torch.float32, device=DEVICE)[None, :]
    x = torch.sin(i * 7e-4 + j * 0.7) + torch.cos(i * 1.3e-3) * 0.5
    score = torch.sin(x[:, 0] * 3.0) + x[:, 5] * x[:, 11]
    return x, score, (score > 0.2).to(torch.float32)


def _tables_numpy(x, model):
    """Raw scores of a fitted binary GBT by numpy alone: the bins by
    ``np.searchsorted`` (side left) on its edges, the leaf of each tree
    from its (feature, cut) table, the leaf values added in tree order in
    float32."""
    edges = model._edges.cpu().numpy()
    feats, cuts, vals = (t.cpu().numpy() for t in model._trees)
    xb = np.stack([np.searchsorted(edges[:, j], x[:, j], side="left")
                   for j in range(x.shape[1])], axis=1)
    pred = np.full(x.shape[0], np.float32(model._base), np.float32)
    for t in range(feats.shape[0]):
        leaf = np.zeros(x.shape[0], np.int64)
        for lvl in range(feats.shape[1]):
            leaf = leaf * 2 + (xb[:, feats[t, lvl]] > cuts[t, lvl])
        pred = pred + vals[t][leaf]
    return pred


def _same_trees(torch, a, b):
    return (torch.equal(a._edges, b._edges)
            and all(torch.equal(u, v) for u, v in zip(a._trees, b._trees)))


def _models_gbdt(torch, app, cpu_app, step, out):
    """Step a: the GBDT at 1,000,000 x 28."""
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.models.trees import GBTClassifier

    n, d = GBDT_N, GBDT_D
    x, score, y = _gbdt_data(torch, n, d)
    X = BlockArray.from_torch(x, backend=app.backend)
    Y = BlockArray.from_torch(y, backend=app.backend)
    levels = GBDT["n_estimators"] * GBDT["max_depth"]
    # A level reads the bins (int32) and g, h, and writes the leaf ids.
    fit_bytes = levels * (4.0 * n * d + 16.0 * n) + 4.0 * n * d
    m1 = step("gbdt_fit_cold", lambda: GBTClassifier(**GBDT).fit(X, Y),
              fit_bytes)
    m2 = step("gbdt_fit_warm", lambda: GBTClassifier(**GBDT).fit(X, Y),
              fit_bytes)
    assert _same_trees(torch, m1, m2), "two GBDT fits differ"
    m3 = []
    out["gbdt_fit_profile"], _ = _profile_summary(torch, lambda: m3.append(
        GBTClassifier(**GBDT).fit(X, Y)))
    assert _same_trees(torch, m1, m3[0]), "a profiled GBDT fit differs"
    pred = step("gbdt_predict", lambda: m1.predict(X),
                4.0 * n * d + 8.0 * n)
    out["gbdt_accuracy"] = float((pred.data == y).to(torch.float64).mean())
    assert out["gbdt_accuracy"] > GBDT_ACC, out
    raw = m1._raw_predict(X)
    x_host = x.cpu().numpy()
    raw_np = _tables_numpy(x_host, m1)
    assert np.array_equal(raw.cpu().numpy(), raw_np), "predict vs numpy"
    want = m1.classes_[(torch.sigmoid(torch.from_numpy(raw_np)) > 0.5)
                       .numpy().astype(np.int64)]
    assert np.array_equal(pred.get(), want.astype(np.float32)), "labels"

    # The card against the CPU route on the first rows: the same bins and
    # splits, the leaf values within GBDT_LEAF_REL.
    r = GBDT_CPU_ROWS
    card = GBTClassifier(**GBDT).fit(
        BlockArray.from_torch(x[:r].contiguous(), backend=app.backend),
        BlockArray.from_torch(y[:r].contiguous(), backend=app.backend))
    t0 = time.perf_counter()
    with _current(cpu_app):
        host = GBTClassifier(**GBDT).fit(
            BlockArray.from_torch(x[:r].cpu(), backend=cpu_app.backend),
            BlockArray.from_torch(y[:r].cpu(), backend=cpu_app.backend))
    out["gbdt_cpu_route_fit_s"] = time.perf_counter() - t0
    assert torch.equal(card._edges.cpu(), host._edges), "edges"
    for a, b in zip(card._trees[:2], host._trees[:2]):
        assert torch.equal(a.cpu(), b), "splits, card vs CPU route"
    _, out["gbdt_leaf_rel_err_card_vs_cpu"] = rel_err(card._trees[2].cpu(),
                                                      host._trees[2])
    assert out["gbdt_leaf_rel_err_card_vs_cpu"] <= GBDT_LEAF_REL, out

    # Three classes, one-vs-rest: the terciles of the score.
    q = torch.quantile(score[::10].double(), torch.tensor(
        [1 / 3, 2 / 3], dtype=torch.float64, device=DEVICE)).float()
    y3 = (score > q[0]).to(torch.float32) + (score > q[1]).to(torch.float32)
    Y3 = BlockArray.from_torch(y3, backend=app.backend)
    m3 = step("gbdt_ovr3_fit", lambda: GBTClassifier(**GBDT).fit(X, Y3),
              3 * fit_bytes)
    proba = step("gbdt_ovr3_predict_proba", lambda: m3.predict_proba(X),
                 4.0 * n * d + 12.0 * n)
    out["gbdt_ovr3_proba_sum_max_abs_err"] = float(
        (proba.data.double().sum(dim=1) - 1.0).abs().max())
    assert out["gbdt_ovr3_proba_sum_max_abs_err"] <= PROBA_SUM_ABS, out
    out["gbdt_ovr3_accuracy"] = float(
        (m3.predict(X).data == y3).to(torch.float64).mean())


def _logistic_ref64(torch, x, y, beta, v, chunk=1 << 18):
    """Float64 Xᵀ(σ(Xβ) − y)/n and Xᵀdiag(s)X·v/n, s = σ(1 − σ)."""
    n = x.shape[0]
    b64, v64 = beta.double(), v.double()
    g = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    hv = torch.zeros_like(g)
    for i in range(0, n, chunk):
        xc = x[i:i + chunk].double()
        p = torch.sigmoid(xc @ b64)
        g += xc.T @ (p - y[i:i + chunk].double())
        hv += xc.T @ (p * (1 - p) * (xc @ v64))
    return g / n, hv / n


def _models_autodiff(torch, app, X, y, step, out):
    """Step d: autodiff and optimize on X and the phase 4 labels."""
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch import autodiff, optimize
    from nums_tpu_torch.core.array.blockarray import BlockArray

    n, d = X.shape
    x_bytes = 4.0 * n * d

    def loss(b):
        eta = X @ b
        return nps.mean(nps.logaddexp(0.0, eta) - y * eta)

    rng = np.random.RandomState(KM_DATA_SEED + 1)
    beta = app.array((0.02 * rng.randn(d)).astype(np.float32))
    v = app.array(rng.randn(d).astype(np.float32))
    val, g = step("value_and_grad", lambda: autodiff.value_and_grad(loss)(
        beta), 2 * x_bytes)
    hv = step("hvp", lambda: autodiff.hvp(loss)(beta, v), 4 * x_bytes)
    g64, hv64 = _logistic_ref64(torch, X.data, y.data, beta.data, v.data)
    _, out["grad_rel_err_vs_f64"] = rel_err(g.data, g64)
    _, out["hvp_rel_err_vs_f64"] = rel_err(hv.data, hv64)
    assert out["grad_rel_err_vs_f64"] <= AD_REL, out
    assert out["hvp_rel_err_vs_f64"] <= AD_REL, out
    assert bool(torch.isfinite(val.data))

    # The gram's gradient: K1 forward (one launch), fp32 backward.
    w = torch.from_numpy(rng.randn(d, d).astype(np.float32)).to(DEVICE)
    W = BlockArray.from_torch(w, backend=app.backend)
    gx = step("gram_grad", lambda: autodiff.grad(
        lambda x: (W * (x.T @ x)).sum())(X),
        2 * x_bytes + 4.0 * d * d, tc_flops=_triangle_flops(n, d),
        flops=2.0 * n * d * d)
    assert out["steps"]["gram_grad"]["launches"] == {"gram": 1}, out
    rows = GRAM_GRAD_ROWS
    want = X.data[:rows].double() @ (w + w.T).double()
    _, out["gram_grad_rel_err_vs_f64"] = rel_err(gx.data[:rows], want)
    assert out["gram_grad_rel_err_vs_f64"] <= GRAM_GRAD_REL, out
    del gx, want

    # minimize: adam, eager and fused, from 0.
    b0 = app.array(np.zeros(d, np.float32))
    loss0 = float(loss(b0).get())
    res = {}
    for kind in ("eager", "fused"):
        res[kind] = step(f"minimize_{kind}", lambda kind=kind:
                         optimize.minimize(loss, b0, fused=kind == "fused",
                                           **OPT),
                         2 * x_bytes * OPT["steps"])
        out[f"minimize_{kind}"] = {
            "n_iter": res[kind].n_iter, "fun": res[kind].fun,
            "grad_max": res[kind].grad_max,
            "seconds_per_step": out["steps"][f"minimize_{kind}"]["seconds"]
            / res[kind].n_iter,
            "bound_ms_per_step": _bound(2 * x_bytes, 0.0)[0]}
    assert res["eager"].n_iter == res["fused"].n_iter == OPT["steps"], out
    out["minimize_x_max_abs_diff"] = float(
        (res["eager"].x.data - res["fused"].x.data).abs().max())
    assert out["minimize_x_max_abs_diff"] <= OPT_X_ABS, out
    out["loss_at_0"] = loss0
    assert res["eager"].fun < loss0 and res["fused"].fun < loss0, out

    def impure(b):
        out_ = loss(b)
        out_.get()  # a host sync inside the differentiated function
        return out_

    try:
        autodiff.grad(impure)(beta)
    except RuntimeError as e:
        assert "INSIDE the traced function" in str(e)
        out["purity_guard"] = "raised"
    else:
        raise AssertionError("a host sync inside f did not raise")


def _planted_partition(torch, X):
    """X plus one of KM_K planted centers per row, added in place a row
    chunk at a time: the planted labels on the card."""
    rng = np.random.RandomState(KM_DATA_SEED)
    centers = torch.from_numpy(
        (KM_CENTER_SCALE * rng.randn(KM_K, D_FULL)).astype(np.float32)
    ).to(DEVICE)
    labels = torch.from_numpy(rng.randint(0, KM_K, N_FULL)).to(DEVICE)
    for i in range(0, N_FULL, 1 << 18):
        X.data[i:i + (1 << 18)] += centers[labels[i:i + (1 << 18)]]
    return labels


def _lloyd64(torch, x, labels, k, chunk=1 << 18):
    """Float64 centers of an assignment and its inertia."""
    d = x.shape[1]
    sums = torch.zeros(k, d, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        sums.index_add_(0, labels[i:i + chunk], x[i:i + chunk].double())
    counts = torch.bincount(labels, minlength=k).double()
    centers = sums / counts[:, None]
    inertia = 0.0
    for i in range(0, x.shape[0], chunk):
        diff = x[i:i + chunk].double() - centers[labels[i:i + chunk]]
        inertia += float((diff * diff).sum())
    return centers, inertia


def _models_kmeans(torch, app, X, step, out):
    """Step b: KMeans(16) at 2.5M x 1000 on X plus planted centers."""
    from nums_tpu_torch.core.ops import random_ops, threefry
    from nums_tpu_torch.models import cluster

    n, d = X.shape
    x_bytes = 4.0 * n * d
    planted = _planted_partition(torch, X)
    first = random_ops.jr_randint(
        threefry.fold_in(threefry.seed_key(KM_SEED, False), 0), (), 0, n,
        torch.int32, DEVICE, False)
    assert int(first) == KM_FIRST_INDEX, int(first)
    seeded = []
    plusplus = cluster._plusplus_init

    def spy(*args):
        seeded.append(plusplus(*args))
        return seeded[-1]

    cluster._plusplus_init = spy
    try:
        km = step("kmeans_fit", lambda: cluster.KMeans(
            n_clusters=KM_K, seed=KM_SEED).fit(X), 0.0)
    finally:
        cluster._plusplus_init = plusplus
    assert torch.equal(seeded[0][0], X.data[KM_FIRST_INDEX]), "first row"
    out["kmeans_fit_profile"], _ = _profile_summary(
        torch, lambda: cluster.KMeans(n_clusters=KM_K, seed=KM_SEED).fit(X))
    out["kmeans_n_iter"] = km.n_iter_
    # Bound of the fit: one read of X per distance pass (k - 1 seeding
    # passes, one per Lloyd iteration, one for the labels).
    out["steps"]["kmeans_fit"].update(zip(
        ("bound_ms", "bound_by"),
        _bound(x_bytes * (KM_K + km.n_iter_), 0.0)))
    labels = km.labels_.data.to(torch.int64)
    table = torch.bincount(labels * KM_K + planted,
                           minlength=KM_K * KM_K).view(KM_K, KM_K)
    nonzero = table > 0
    assert bool((nonzero.sum(0) == 1).all() and (nonzero.sum(1) == 1).all()
                ), "the planted partition was not recovered"
    c64, inertia64 = _lloyd64(torch, X.data, labels, KM_K)
    _, out["kmeans_centers_rel_err_vs_f64"] = rel_err(
        km.cluster_centers_.data, c64)
    out["kmeans_inertia_rel_err_vs_f64"] = abs(
        km.inertia_ - inertia64) / inertia64
    assert out["kmeans_centers_rel_err_vs_f64"] <= KM_REL, out
    assert out["kmeans_inertia_rel_err_vs_f64"] <= KM_REL, out
    km2 = cluster.KMeans(n_clusters=KM_K, seed=KM_SEED).fit(X)
    assert torch.equal(km2.cluster_centers_.data, km.cluster_centers_.data)
    assert torch.equal(km2.labels_.data, km.labels_.data)
    assert km2.inertia_ == km.inertia_ and km2.n_iter_ == km.n_iter_
    centers = km.cluster_centers_.data
    xd = X.data
    step("kmeans_lloyd_iteration",
         lambda: cluster._update(centers, *cluster._assign_stats(
             xd, centers, KM_K)[1:3]), x_bytes)
    step("kmeans_predict", lambda: km.predict(X), x_bytes)


def phase_models(torch, smi, app, X, y):
    """Phase 14 (the module docstring lists its checks): the GBDT, KMeans,
    autodiff and optimize at full width. Any breach raises. No kernel but
    K1 (once, in the gram's gradient) may launch."""
    from nums_tpu_torch.core import application_manager, settings

    t_phase = time.perf_counter()
    out = {"phase": "models", "nvidia_smi": smi, "shape": [N_FULL, D_FULL],
           "steps": {}}
    application_manager.set_instance(app)
    step = _stepper(torch, out["steps"])
    saved = settings.default_float_for
    settings.default_float_for = lambda device: np.dtype(np.float32)
    try:
        cpu_app = application_manager.create(device="cpu")
    finally:
        settings.default_float_for = saved
    _reset_counts()
    _models_gbdt(torch, app, cpu_app, step, out)
    torch.cuda.empty_cache()
    _models_autodiff(torch, app, X, y, step, out)
    torch.cuda.empty_cache()
    _models_kmeans(torch, app, X, step, out)
    out["launches"] = _counts()
    assert out["launches"] == {**{k: 0 for k in out["launches"]},
                               "gram": 1}, out["launches"]
    out["peak_bytes"] = max(s["peak_bytes"] for s in out["steps"].values())
    out["seconds"] = time.perf_counter() - t_phase
    out["limit_seconds"] = MODELS_LIMIT_S
    emit(out)
    assert out["seconds"] <= MODELS_LIMIT_S, out["seconds"]
    return out


# Phase 15, the mesh backend: in the full run on this card alone (a
# world-1 NCCL group, phase 4's main path bit for bit); with --mesh-only,
# one process per visible card at the reference's 4-GPU size.
MESH_N = 10_000_000          # --mesh-only rows: x 1000 fp32 = 40 GB
MESH_NT_ROWS = 1024          # Xs of X @ Xs.T: the product is 10 GB a card
MESH_NT_SEED, MESH_RING_SEED, MESH_SUMMA_SEED = 2718, 3141, 1618
MESH_CHECK_ROWS = 4096       # each shard's first rows held to a serial draw
MESH_SUMMA_CHECK_ROWS = 64   # ... and each (2, 2) block's, a row at a time
SCHED_REL = 1e-5             # fp32 products (TF32 off) over k <= 1000 vs
                             # float64, of max|ref|
ROUTES_REL = SMALL_REL       # the two gram routes: the same K1 partials,
                             # summed by an all-reduce or a reduce-scatter
MESH_GRAM_REL = 1e-4         # K1's G at 10M rows vs float64, of max|G| (the
                             # diagonal, about n): both routes read 9.05e-6
                             # at 10M x 1000 on four H100s at 700 W
MESH_GRAM_OFF_REL = 1e-2     # ... its off-diagonal entries, of their own
                             # max (about 4.5 sqrt(n)): bf16 rounding of X
                             # alone gives about 2e-3 at any n; a zeroed or
                             # misplaced off-diagonal reads about 1
MESH_CHUNK = 1 << 18         # rows of a float64 reference at a time
MESH_REPS = 3
MESH_DEADLINE_S = 840.0      # every rank exits 0 within, or the run fails


def _x_checksum(torch, x, chunk=1 << 18):
    """Sum of X's float32 bit patterns as int64, a chunk of rows at a
    time: equal for equal bits."""
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        total += x[i:i + chunk].view(torch.int32).sum(dtype=torch.int64)
    return total


def _known_draws(torch, local, r0, d):
    """RANDOM_KNOWN's normals at the flat positions of a (4·N_FULL, D_FULL)
    draw that this shard, from row ``r0``, holds: (checked, max_abs_err)."""
    positions = RANDOM_KNOWN["positions"] + RANDOM_KNOWN[
        "positions_beyond_2_32"]
    flat = local.reshape(-1)
    lo, hi = r0 * d, r0 * d + flat.numel()
    errs = []
    for p, v in zip(positions, RANDOM_KNOWN["normal"]):
        if lo <= p < hi:
            got = float(flat[p - lo])
            assert abs(got - v) <= NORMAL_KNOWN_REL * abs(v) + \
                NORMAL_KNOWN_ABS, (p, got, v)
            errs.append(abs(got - v))
    return len(errs), max(errs, default=0.0)


def _mesh_sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _all_max(torch, value):
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_mesh_device(torch))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _mesh_device(torch):
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh_time_ms(torch, fn, reps=MESH_REPS):
    """Median of ``reps`` timed calls after a warm-up, each started after a
    barrier (CUDA events on the card); the slowest rank's."""
    from nums_tpu_torch.core import multiprocess

    fn()
    _mesh_sync(torch)
    times = []
    for _ in range(reps):
        multiprocess.barrier("time")
        if DEVICE == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return _all_max(torch, statistics.median(times))


def _mesh_seconds(torch, fn):
    """(fn(), host seconds from a barrier to its end on this rank, the
    slowest rank's)."""
    from nums_tpu_torch.core import multiprocess

    multiprocess.barrier("clock")
    t0 = time.perf_counter()
    out = fn()
    _mesh_sync(torch)
    return out, _all_max(torch, time.perf_counter() - t0)


def _draw_mesh_x(torch, app, n, d):
    rows = -(-n // app.backend.num_devices)
    return app.random_state(RANDOM_KNOWN["seed"]).normal(
        shape=(n, d), block_shape=(rows, d), dtype=np.float32)


def phase_mesh(torch, smi, keep):
    """Phase 15 in the full run: a world-1 NCCL group (a file:// rendezvous
    under a temporary directory) and a MeshBackend over this card; phase
    4's draw, X.T @ X under ``auto`` and the fused fit on it, each bit for
    bit phase 4's (an all-reduce over one rank is the identity), with
    their launches (K1 once, the statistics 10 times, one stage)."""
    import tempfile

    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager, settings
    from nums_tpu_torch.core.ops import summa
    from nums_tpu_torch.models.glms import LogisticRegression

    t_phase = time.perf_counter()
    saved = application_manager._instance
    out = {"phase": "mesh", "nvidia_smi": smi, "world": 1,
           "shape": [N_FULL, D_FULL]}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0)
        try:
            app = application_manager.create(
                device=None if DEVICE == "cuda" else DEVICE, backend="mesh")
            application_manager.set_instance(app)
            _reset_counts()
            X = _draw_mesh_x(torch, app, N_FULL, D_FULL)
            local = X.raw.to_local()
            out["known_answers"], _ = _known_draws(torch, local, 0, D_FULL)
            assert int(_x_checksum(torch, local)) == keep["x_checksum"]
            settings.collective_matmul = "auto"
            try:
                G = X.T @ X
                G.touch()
            finally:
                settings.collective_matmul = "0"
            out["last_dispatch"] = summa.LAST_DISPATCH
            assert summa.LAST_DISPATCH == "xla", summa.LAST_DISPATCH
            assert torch.equal(G.data.full_tensor().cpu(), keep["gram"])
            y = draw_labels(torch, app, X)
            model = LogisticRegression(**FIT).fit(X, y)
            beta = torch.cat([model.coef_.data.full_tensor(),
                              model.intercept_.data.full_tensor()[None]])
            assert torch.equal(beta.cpu(), keep["beta"]), "beta vs phase 4"
            out["accuracy"] = float(model.score(X, y))
            assert out["accuracy"] == keep["accuracy"], out["accuracy"]
            out["launches"] = _counts()
            assert out["launches"] == {"gram": 1, "gram_weighted": 10,
                                       "newton_stage": 1,
                                       "newton_stats": 10}, out["launches"]
            h = torch.zeros((D_FULL + 1, D_FULL + 1), dtype=torch.float32,
                            device=local.device)
            out["all_reduce_h_ms"] = _mesh_time_ms(torch,
                                                   lambda: dist.all_reduce(h))
            del G, model, local, h
            torch.cuda.empty_cache()
            out["seconds"] = time.perf_counter() - t_phase
            out["bitwise_vs_phase_4"] = ["draw", "gram", "beta", "accuracy"]
            emit(out)
            # Phase 17 on the same world-1 mesh and X.
            masks = phase_masks(torch, smi, app, X, y)
            torch.cuda.empty_cache()
            # Phase 19 on the same world-1 mesh and X.
            shape = phase_shape(torch, smi, app, X)
            torch.cuda.empty_cache()
            # Phase 20 on the same world-1 mesh, on a copy of X's rows.
            mesh_random = phase_mesh_random(torch, smi, app, X)
            torch.cuda.empty_cache()
            # Phase 21 on the same world-1 mesh and X's rows.
            signal = phase_mesh_signal(torch, smi, app, X)
            torch.cuda.empty_cache()
            # Phase 18 on the same world-1 mesh and X (its last step
            # writes into X).
            core = phase_mesh_core(torch, smi, app, X, y)
            del X, y
            torch.cuda.empty_cache()
            # Phase 16 on the same world-1 mesh.
            ooc = phase_mesh_ooc(torch, smi, app)
            app.backend.shutdown()
        finally:
            application_manager.set_instance(saved)
            dist.destroy_process_group()
    return out, ooc, masks, core, shape, mesh_random, signal


class _Tee:
    def __init__(self, *streams):
        self._streams = streams

    def write(self, text):
        for s in self._streams:
            s.write(text)
            s.flush()
        return len(text)

    def flush(self):
        for s in self._streams:
            s.flush()


def _mesh_rank(rank, world, init_file, cfg):
    """One process of --mesh-only, on ``cuda:<rank>``: joins the NCCL group
    through the file:// rendezvous and runs ``_mesh_cards``. Its output
    goes to ``mesh_logs/mesh_rank<rank>.log`` (rank 0's to standard
    output too); a traceback of every thread goes there if it hangs."""
    import faulthandler

    global DEVICE
    DEVICE = cfg["device"]
    log = open(os.path.join(cfg["out_dir"], f"mesh_rank{rank}.log"), "w")
    sys.stdout = _Tee(sys.stdout, log) if rank == 0 else _Tee(log)
    sys.stderr = _Tee(sys.stderr, log)
    faulthandler.dump_traceback_later(cfg["deadline"] - 30, file=log)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    os.environ.update({
        "LOCAL_RANK": str(rank), "NUMS_TPU_TORCH_INIT_FILE": init_file,
        "NUMS_TPU_TORCH_NUM_PROCESSES": str(world),
        "NUMS_TPU_TORCH_PROCESS_ID": str(rank)})
    sys.path.insert(0, cfg["root"])
    try:
        import torch
        import torch.distributed as dist

        from nums_tpu_torch.core import multiprocess

        if DEVICE == "cuda":
            torch.cuda.set_device(rank)
        multiprocess.initialize(DEVICE)
        globals()[cfg.get("entry", "_mesh_cards")](torch, cfg)
        multiprocess.barrier("done")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent sees the exit code
        traceback.print_exc()
        sys.stdout.flush()
        log.flush()
        os._exit(1)
    faulthandler.cancel_dump_traceback_later()
    sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    log.close()


def _mesh_cards(torch, cfg):
    """Every step of --mesh-only on this rank (the module docstring lists
    them); rank 0 prints one JSON line a step."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager

    world, rank = dist.get_world_size(), dist.get_rank()
    n, d = cfg["n"], cfg["d"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if rank == 0 else (lambda obj: print(json.dumps(obj)))
    head = {"world": world, "shape": [n, d], "cluster_shape": [world, 1]}
    X = _mesh_draw_step(torch, app, n, d, cfg, say, head)
    G = _mesh_gram_step(torch, app, X, say, head)
    _mesh_nt_step(torch, app, X, cfg, say, head)
    _mesh_ring_step(torch, app, X, say, head)
    y, beta, iters = _mesh_fit_step(torch, app, X, d, say, head)
    # Phase 16 on the same X, held to these in-core results.
    _mesh_ooc_cards(torch, app, X, y, {"gram": G, "beta": beta,
                                       "iterations": iters}, cfg, say, head)
    del X, y, G
    _mesh_free(torch)
    if world % 2 == 0 and world >= 4:
        _mesh_summa_step(torch, n, d, world, say, head)
    peaks = [None] * world
    dist.all_gather_object(peaks, _mesh_peak(torch))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "mesh", "step": "cards", **head,
         "peak_bytes_per_card": peaks, "nvidia_smi_per_card": smi})


def _mesh_free(torch):
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def _mesh_peak(torch):
    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


def _mesh_draw_step(torch, app, n, d, cfg, say, head):
    """X drawn on the mesh from phase 4's seed: each shard's first rows
    equal to a serial draw of those flat positions, RANDOM_KNOWN's normals
    wherever a shard holds them."""
    import torch.distributed as dist

    from nums_tpu_torch.core.ops import random_ops, threefry

    _reset_counts()
    X, secs = _mesh_seconds(torch, lambda: _draw_mesh_x(torch, app, n, d))
    local = X.raw.to_local()
    (r0, r1), _ = app.backend.region((n, d), X.raw.placements)
    k = min(cfg["check_rows"], r1 - r0)
    key = threefry.fold_in(threefry.seed_key(RANDOM_KNOWN["seed"], False),
                           RANDOM_KNOWN["counter"])
    serial = random_ops.jr_normal(key, (n, d), torch.float32, local.device,
                                  flat_range=(r0 * d, (r0 + k) * d))
    assert torch.equal(local[:k].reshape(-1), serial), "shard vs serial"
    known, err = _known_draws(torch, local, r0, d)
    counts = [None] * app.backend.num_devices
    dist.all_gather_object(counts, (r0, r1, known))
    if n * d >= 4 * N_FULL * D_FULL:  # every known position is held
        assert sum(c[2] for c in counts) == len(RANDOM_KNOWN["normal"])
    say({"phase": "mesh", "step": "draw", **head, "seconds": secs,
         "rows_per_rank": [[c[0], c[1]] for c in counts],
         "known_answers_per_rank": [c[2] for c in counts],
         "known_max_abs_err": _all_max(torch, err),
         "serial_rows_checked": k, "bound_ms": _bound(4.0 * n * d / len(
             counts), 0.0)[0]})
    return X


def _mesh_gram_step(torch, app, X, say, head):
    """X.T @ X under the default route (K1 + all-reduce) and under auto
    (``tn``: K1 + reduce-scatter), each held to a float64 gram (each
    rank's rows, all-reduced in float64), whole and off the diagonal, and
    to each other."""
    import torch.distributed as dist

    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import cuda_gram, summa

    local = X.raw.to_local()
    g64 = _gram64(local)
    dist.all_reduce(g64)
    out, grams = {}, {}
    for route, mode in (("default", "0"), ("tn", "auto")):
        settings.collective_matmul = mode
        try:
            summa.LAST_DISPATCH = None
            _reset_counts()
            G = X.T @ X
            G.touch()
            launches = _counts()["gram"]
            dispatch = summa.LAST_DISPATCH
            grams[route] = G.data.full_tensor()
            _, rel = rel_err(grams[route], g64)
            off = _offdiag_rel(torch, grams[route], g64)
            ms = _mesh_time_ms(torch, lambda: (X.T @ X).touch())
        finally:
            settings.collective_matmul = "0"
        assert launches == 1, (route, launches)
        assert rel <= MESH_GRAM_REL, (route, rel)
        assert off <= MESH_GRAM_OFF_REL, (route, "off-diagonal", off)
        want = None if mode == "0" else (
            "tn" if app.backend.num_devices > 1 else "xla")
        assert dispatch == want, (route, dispatch)
        out[route] = {"ms": ms, "rel_err_vs_f64": rel,
                      "offdiag_rel_err_vs_f64": off,
                      "k1_launches_per_rank": launches,
                      "last_dispatch": dispatch}
        del G
    _, routes = rel_err(grams["tn"], grams["default"])
    assert routes <= ROUTES_REL, routes
    n_local, d = local.shape
    out["k1_local_ms"] = _mesh_time_ms(torch, lambda: cuda_gram.gram(local))
    g = torch.zeros((d, d), dtype=torch.float32, device=local.device)
    out["all_reduce_g_ms"] = _mesh_time_ms(torch, lambda: dist.all_reduce(g))
    out["k1_bound_ms"], out["k1_bound_by"] = _gram_bound(n_local, d)
    say({"phase": "mesh", "step": "gram", **head, **out,
         "routes_rel_err": routes, "tolerance": MESH_GRAM_REL,
         "offdiag_tolerance": MESH_GRAM_OFF_REL})
    return grams["default"]


def _offdiag_rel(torch, got, ref):
    """max|got - ref| over the off-diagonal entries, of their own
    max|ref|: a fault there is not hidden under the diagonal's scale."""
    off = ~torch.eye(ref.shape[0], dtype=torch.bool, device=ref.device)
    err = float((got.double() - ref)[off].abs().max())
    return err / float(ref[off].abs().max())


def _chunked_rel(torch, got, ref_fn, rows, chunk=MESH_CHUNK):
    """(max|got - ref|, max|ref|) over row chunks, ``ref_fn(i, j)`` the
    float64 reference of rows [i, j), the slowest rank's maxima."""
    err = scale = 0.0
    for i in range(0, rows, chunk):
        j = min(i + chunk, rows)
        ref = ref_fn(i, j)
        err = max(err, float((got[i:j].double() - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
        del ref
    return _all_max(torch, err), _all_max(torch, scale)


def _mesh_nt_step(torch, app, X, cfg, say, head):
    """X @ Xs.T under auto (``nt``): Xs's rows all-gathered, a local
    product; held to a float64 product of each rank's rows."""
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import summa

    world = app.backend.num_devices
    rows = cfg["nt_rows"]
    Xs = app.random_state(MESH_NT_SEED).normal(
        shape=(rows, X.shape[1]), block_shape=(-(-rows // world),
                                               X.shape[1]),
        dtype=np.float32)
    settings.collective_matmul = "auto"
    try:
        summa.LAST_DISPATCH = None
        P = X @ Xs.T
        P.touch()
        dispatch = summa.LAST_DISPATCH
        xs = Xs.data.full_tensor().double()
        local, p_loc = X.raw.to_local(), P.raw.to_local()
        err, scale = _chunked_rel(
            torch, p_loc, lambda i, j: local[i:j].double() @ xs.T,
            local.shape[0])
        del P, p_loc, xs
        _mesh_free(torch)
        ms = _mesh_time_ms(torch, lambda: (X @ Xs.T).touch())
    finally:
        settings.collective_matmul = "0"
    assert dispatch == ("nt" if world > 1 else "xla"), dispatch
    assert err <= SCHED_REL * scale, (err, scale)
    _mesh_free(torch)
    say({"phase": "mesh", "step": "nt", **head, "xs_rows": rows,
         "last_dispatch": dispatch, "ms": ms, "rel_err_vs_f64": err / scale,
         "tolerance": SCHED_REL,
         "output_bytes_per_card": 4.0 * X.shape[0] * rows / world})


def _mesh_ring_step(torch, app, X, say, head):
    """X @ W under ``ring``, W row-sharded; under auto the same shape goes
    to the default route, as in the reference (its B panel is under the
    gather budget). Held to a float64 product of each rank's rows."""
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import summa

    world, d = app.backend.num_devices, X.shape[1]
    W = app.random_state(MESH_RING_SEED).normal(
        shape=(d, d), block_shape=(-(-d // world), d), dtype=np.float32)
    auto = summa.choose_schedule(app.backend, False, False,
                                 X._raw_physical(), W._raw_physical(), 4)
    assert auto is None, auto
    settings.collective_matmul = "ring"
    try:
        summa.LAST_DISPATCH = None
        P = X @ W
        P.touch()
        dispatch = summa.LAST_DISPATCH
        w = W.data.full_tensor().double()
        local, p_loc = X.raw.to_local(), P.raw.to_local()
        err, scale = _chunked_rel(
            torch, p_loc, lambda i, j: local[i:j].double() @ w,
            local.shape[0])
        del P, p_loc, w
        _mesh_free(torch)
        ms = _mesh_time_ms(torch, lambda: (X @ W).touch())
    finally:
        settings.collective_matmul = "0"
    assert dispatch == ("ring" if world > 1 else "xla"), dispatch
    assert err <= SCHED_REL * scale, (err, scale)
    _mesh_free(torch)
    say({"phase": "mesh", "step": "ring", **head, "last_dispatch": dispatch,
         "auto_dispatch": auto or "xla", "ms": ms,
         "rel_err_vs_f64": err / scale, "tolerance": SCHED_REL})


def _newton64(torch, x, y, iters, chunk=MESH_CHUNK):
    """A float64 Newton logistic fit from zeros on each rank's rows, the
    ones column appended, g and H all-reduced in float64 each step: the
    reference of the fused fit."""
    import torch.distributed as dist

    da = x.shape[1] + 1
    beta = torch.zeros(da, dtype=torch.float64, device=x.device)
    for _ in range(iters):
        g = torch.zeros(da, dtype=torch.float64, device=x.device)
        H = torch.zeros((da, da), dtype=torch.float64, device=x.device)
        for i in range(0, x.shape[0], chunk):
            xc = torch.cat([x[i:i + chunk].double(), torch.ones(
                (min(chunk, x.shape[0] - i), 1), dtype=torch.float64,
                device=x.device)], dim=1)
            mu = torch.sigmoid(xc @ beta)
            g += xc.T @ (mu - y[i:i + chunk].double())
            H += (xc * (mu * (1 - mu))[:, None]).T @ xc
            del xc
        dist.all_reduce(g)
        dist.all_reduce(H)
        beta = beta - torch.linalg.solve(H, g)
    return beta


def _mesh_fit_step(torch, app, X, d, say, head):
    """The fused logistic fit on phase 4's labels: each rank stages its
    rows once and runs K3 ten times, one all-reduce of g and H a step;
    β held to a float64 Newton fit, the accuracy to the planted β's."""
    import torch.distributed as dist

    from nums_tpu_torch.core.ops import cuda_newton, summa
    from nums_tpu_torch.models import fast_glm
    from nums_tpu_torch.models.glms import LogisticRegression

    y, beta_true = planted_labels(torch, app, X)
    _reset_counts()
    model, fit_secs = _mesh_seconds(
        torch, lambda: LogisticRegression(**FIT).fit(X, y))
    launches = _counts()
    assert launches == {"gram": 0, "gram_weighted": FIT["max_iter"],
                        "newton_stage": 1,
                        "newton_stats": FIT["max_iter"]}, launches
    beta = torch.cat([model.coef_.data.full_tensor(),
                      model.intercept_.data.full_tensor()[None]])
    rows = summa.row_layout(X.raw)
    local = X.raw.to_local()
    yl = y.raw.redistribute(app.backend.mesh, rows).to_local()
    beta64 = _newton64(torch, local, yl, FIT["max_iter"])
    _, beta_rel = rel_err(beta, beta64)
    assert beta_rel <= BETA_REL, beta_rel
    acc = float(model.score(X, y))
    acc_true = float((((X @ beta_true) > 0).astype(np.float32) == y).mean())
    assert abs(acc - acc_true) <= ACC_SLACK, (acc, acc_true)
    fit_ms = _mesh_time_ms(torch, lambda: LogisticRegression(**FIT).fit(
        X, y), reps=1)
    # One Newton step alone (K3 on the staged rows, the all-reduce, the
    # replicated solve), and the all-reduce of g and H alone.
    xa = torch.cat([local, torch.ones((local.shape[0], 1), dtype=local.dtype,
                                      device=local.device)], dim=1)
    staged = cuda_newton.prepare(xa)
    del xa
    reduce = fast_glm.mesh_reduce(app.backend.mesh, rows)
    b0 = torch.zeros(d + 1, dtype=torch.float32, device=local.device)
    step_ms = _mesh_time_ms(torch, lambda: fast_glm._newton_step_penalized(
        "logistic", staged, yl, b0, None, kernels=True, reduce=reduce))
    k3_ms = _mesh_time_ms(torch, lambda: cuda_newton.stats(
        staged, yl, b0, "logistic"))
    del staged
    h = torch.zeros((d + 1) * (d + 2), dtype=torch.float32,
                    device=local.device)
    ar_ms = _mesh_time_ms(torch, lambda: dist.all_reduce(h))
    say({"phase": "mesh", "step": "fit", **head, "seconds": fit_secs,
         "fit_ms": fit_ms, "newton_step_ms": step_ms, "k3_local_ms": k3_ms,
         "all_reduce_g_h_ms": ar_ms, "all_reduce_bytes": 4 * h.numel(),
         "launches_per_rank": launches, "beta_rel_err_vs_f64": beta_rel,
         "beta_tolerance": BETA_REL, "accuracy": acc,
         "accuracy_true_beta": acc_true})
    _mesh_free(torch)
    return y, beta, launches["newton_stats"]


def _mesh_summa_step(torch, n, d, world, say, head):
    """X @ W on a (2, world/2) mesh under ``summa``: X drawn again from its
    seed as (n/2, d/(world/2)) blocks (one range of positions per local
    row; the first rows held to the serial draw), A's row panel
    all-gathered over m1 and B's column panel over m0. Held to a float64
    product: each rank's rows times its own columns' rows of W, summed
    over m1 a chunk of rows at a time."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager, settings
    from nums_tpu_torch.core.ops import random_ops, summa, threefry

    shape = (2, world // 2)
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=shape)
    application_manager.set_instance(app)
    block = (-(-n // shape[0]), -(-d // shape[1]))
    X, draw_secs = _mesh_seconds(
        torch, lambda: app.random_state(RANDOM_KNOWN["seed"]).normal(
            shape=(n, d), block_shape=block, dtype=np.float32))
    W = app.random_state(MESH_SUMMA_SEED).normal(
        shape=(d, d), block_shape=block[1:] * 2, dtype=np.float32)
    settings.collective_matmul = "summa"
    try:
        summa.LAST_DISPATCH = None
        P = X @ W
        P.touch()
        dispatch = summa.LAST_DISPATCH
    finally:
        settings.collective_matmul = "0"
    assert dispatch == "summa", dispatch
    local, p_loc = X.raw.to_local(), P.raw.to_local()
    (r0, _), (k0, k1) = app.backend.region((n, d), X.raw.placements)
    # This block's first rows (one range of positions each) are the
    # serial draw's, each row drawn alone as a flat range.
    key = threefry.fold_in(threefry.seed_key(RANDOM_KNOWN["seed"], False),
                           RANDOM_KNOWN["counter"])
    for i in range(min(MESH_SUMMA_CHECK_ROWS, local.shape[0])):
        at = ((r0 + i) * d + k0, (r0 + i) * d + k1)
        assert torch.equal(local[i], random_ops.jr_normal(
            key, (n, d), torch.float32, local.device, flat_range=at)), i
    (_, _), (c0, c1) = app.backend.region(tuple(P.shape), P.raw.placements)
    w = W.data.full_tensor().double()
    group = app.backend.mesh.get_group(1)

    def ref(i, j):
        q = local[i:j].double() @ w[k0:k1]
        dist.all_reduce(q, group=group)
        return q[:, c0:c1]

    err, scale = _chunked_rel(torch, p_loc, ref, local.shape[0],
                              chunk=MESH_CHUNK // 4)
    assert err <= SCHED_REL * scale, (err, scale)
    del P, p_loc, w
    _mesh_free(torch)
    settings.collective_matmul = "summa"
    try:
        ms = _mesh_time_ms(torch, lambda: (X @ W).touch())
    finally:
        settings.collective_matmul = "0"
    say({"phase": "mesh", "step": "summa", **head,
         "cluster_shape": list(shape), "x_local_shape": list(local.shape),
         "draw_seconds": draw_secs, "last_dispatch": dispatch, "ms": ms,
         "rel_err_vs_f64": err / scale, "tolerance": SCHED_REL,
         "a_panel_bytes_per_card": 4.0 * local.shape[0] * d})
    del X, W, local
    _mesh_free(torch)


def phase_mesh_cards(torch, smi):
    """--mesh-only: one process per visible card (``spawn``, NCCL, a
    file:// rendezvous under a temporary directory). Fails unless every
    rank exits 0 before ``MESH_DEADLINE_S``; a rank that fails ends the
    run at once. Returns the number of ranks."""
    import shutil
    import tempfile

    from nums_tpu_torch.core import settings

    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    # Phase 16's files: X spilled (4·N·d bytes) and what comes of it, or
    # the 2.5M-row slice and its replica before it; N is cut to a multiple
    # of 1,000,000 rows only where the disk cannot hold them.
    os.makedirs(settings.data_dir, exist_ok=True)
    free = shutil.disk_usage(settings.data_dir).free
    fixed = max(8.0 * MESH_OOC_SLICE * D_FULL, 6e9) + MESH_OOC_MARGIN_BYTES
    ooc_n = MESH_N
    while ooc_n > 1_000_000 and free < max(fixed, 4.0 * ooc_n * D_FULL * 1.1
                                           + MESH_OOC_MARGIN_BYTES):
        ooc_n = (ooc_n - 1) // 1_000_000 * 1_000_000
    assert free >= max(fixed, 4.0 * ooc_n * D_FULL * 1.1
                       + MESH_OOC_MARGIN_BYTES), (
        f"phase 16 cannot fit under {settings.data_dir}: {free / 1e9:.1f} "
        "GB are free")
    ooc_root = tempfile.mkdtemp(prefix="chip_smoke_mesh_ooc-",
                                dir=settings.data_dir)
    cfg = {"n": MESH_N, "d": D_FULL, "nt_rows": MESH_NT_ROWS,
           "check_rows": MESH_CHECK_ROWS, "device": DEVICE,
           "deadline": MESH_DEADLINE_S + MESH_OOC_DEADLINE_S,
           "out_dir": out_dir, "root": root, "ooc_root": ooc_root,
           "ooc_n": ooc_n}
    emit({"phase": "mesh_start", "world": world, "nvidia_smi": smi,
          "shape": [cfg["n"], cfg["d"]], "data_dir_free_bytes": free,
          "mesh_ooc_rows": ooc_n, "mesh_ooc_cut": ooc_n != MESH_N})
    t0 = time.perf_counter()
    try:
        codes = _spawn_ranks(world, cfg)
        assert codes == [0] * world, ("mesh ranks' exit codes", codes)
        emit({"phase": "mesh_done", "world": world, "exit_codes": codes,
              "seconds": time.perf_counter() - t0})
        _mesh_ooc_world1_kmeans(torch, ooc_root, world)
    finally:
        shutil.rmtree(ooc_root, ignore_errors=True)
    return world


# Phase 16, out of core on the mesh: in the full run on this card alone (a
# world-1 mesh of MESH_OOC_N1 rows in MESH_OOC_PANELS1 panels, the mesh
# branch of ooc_put and the streamed folds); with --mesh-only, on every
# card at phase 15's X and against its in-core results.
MESH_OOC_N1 = 1_000_000        # the default run: 1M x 1000 fp32, 4 GB
MESH_OOC_PANELS1 = 4
MESH_OOC_SLICE = 2_500_000     # --mesh-only I/O checks: a 10 GB slice
MESH_OOC_MARGIN_BYTES = 10e9   # free space kept beyond the phase's files
MESH_OOC_DEADLINE_S = 900.0    # the phase's own deadline, every rank: it
                               # took 497 s on four H100s (I/O included)
MESH_OOC_TSQR_REL = 1e-4       # RᵀR (fp32 Householder) vs the float64 gram
MESH_OOC_CHECK_ROWS = 4096     # transform rows held to a float64 projection


def _whole(t):
    """A (replicated) DTensor's value as one plain tensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _ooc_mesh_step(torch, steps, name, fn):
    """fn() as one step of phase 16: after a barrier, the launch counts
    and the bytes read through ``PanelRef.load`` set to 0 and the peak
    device memory reset; after it (synchronized) the host-clock seconds
    (the slowest rank's), each card's launches, bytes read and peak above
    what was allocated before the step, in ``steps[name]``. Returns
    (fn(), this rank's launch counts)."""
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess
    from nums_tpu_torch.core.array import diskarray

    multiprocess.barrier(name)
    _mesh_sync(torch)
    base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    diskarray.PANEL_BYTES_READ["bytes"] = 0
    t0 = time.perf_counter()
    out = fn()
    _mesh_sync(torch)
    secs = time.perf_counter() - t0
    counts = _counts()
    mine = {"launches": counts,
            "panel_bytes_read": diskarray.PANEL_BYTES_READ["bytes"],
            "peak_above_before_bytes": (
                torch.cuda.max_memory_allocated() - base
                if DEVICE == "cuda" else 0)}
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, mine)
    steps[name] = {
        "seconds": _all_max(torch, secs),
        "launches_per_card": [p["launches"] for p in per],
        "panel_bytes_read_per_rank": [p["panel_bytes_read"] for p in per],
        "peak_above_before_bytes_per_card": [
            p["peak_above_before_bytes"] for p in per]}
    return out, counts


def _rank_rows(app, rows):
    """(lo, hi): this rank's rows of a streamed panel of ``rows`` rows."""
    from nums_tpu_torch.core.ops import streaming

    (lo, hi), = app.backend.region((rows,), streaming.row_placements(
        app.backend.mesh))
    return lo, hi


def _panels_with_rows(app, dX):
    """The panels of ``dX`` of which this rank holds rows, and its rows of
    them all."""
    spans = [_rank_rows(app, b - a) for a, b in dX.grid.grid_slices[0]]
    return sum(1 for lo, hi in spans if hi > lo), sum(hi - lo
                                                      for lo, hi in spans)


def _counting_block_writes(written):
    """Wrap the checkpoint writer's block engine and np.save to record the
    block files this process writes; returns the undo."""
    from nums_tpu_torch.core.io import filesystem

    native, save = filesystem.shard_native.write_shards, filesystem.np.save

    def write_shards(items):
        written.extend(os.path.basename(p) for p, _ in items)
        return native(items)

    def np_save(path, arr, *args, **kwargs):
        written.append(os.path.basename(str(path)))
        return save(path, arr, *args, **kwargs)

    filesystem.shard_native.write_shards = write_shards
    filesystem.np.save = np_save

    def undo():
        filesystem.shard_native.write_shards = native
        filesystem.np.save = save

    return undo


def _bits_same(torch, a, b):
    """Equal shape and bits, on the card."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _all_true(torch, flag):
    """Whether ``flag`` holds on every rank."""
    return _all_max(torch, 0.0 if flag else 1.0) == 0.0


def _mesh_stats_pass(torch, app, dX, y_at, beta, kind):
    """(g, H) of one streamed Newton statistics pass on the mesh, as
    ``newton_fit_ooc`` makes it: each rank's rows of each panel augmented
    on its card and folded by ``streaming.glm_stats_update_aug``, one
    all-reduce after the pass."""
    from nums_tpu_torch.core.array.application import ooc_panels, ooc_put
    from nums_tpu_torch.core.ops import streaming

    da = dX.shape[1] + 1
    dev = app.backend.device
    g = torch.zeros(da, device=dev)
    H = torch.zeros(da, da, device=dev)
    for start, panel in ooc_panels(dX):
        p, _ = ooc_put(app.backend, panel)
        yp, _ = ooc_put(app.backend, y_at(start, panel.shape[0]))
        x = streaming.local_rows(p)
        if x.shape[0]:
            streaming.glm_stats_update_aug(kind, g, H, streaming.augment_ones(
                x), streaming.local_rows(yp), beta)
    streaming.reduce_rows(app.backend.mesh, [g, H])
    return g, H


def _rows64(torch, x, y=None, chunk=MESH_CHUNK):
    """Float64 column sums of ``x`` and xᵀy (None without y), a chunk of
    rows at a time."""
    s = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    b = None if y is None else torch.zeros_like(s)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        s += c.sum(dim=0)
        if y is not None:
            b += c.T @ y[i:i + chunk].double()
    return s, b


def _mesh_ooc_pass_parts(torch, app, dX, dy, beta):
    """One mesh pass taken apart on this rank: the host read of its rows
    of every panel, their moves to the card, K3 one-shot on them, and the
    all-reduce of g and H; then K1, K2 and K3 on its rows of the first
    panel against their plain versions (``_kernels_at``)."""
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess
    from nums_tpu_torch.core.ops import cuda_newton, streaming

    multi = multiprocess.is_multiprocess()
    spans = [(i, _rank_rows(app, b - a))
             for i, (a, b) in enumerate(dX.grid.grid_slices[0])]
    refs = dict(enumerate(r for _, r in dX.iter_panel_refs()))
    yrefs = dict(enumerate(r for _, r in dy.iter_panel_refs()))
    host, read_s = [], 0.0
    for i, (lo, hi) in spans:
        if hi <= lo:
            continue
        t0 = time.perf_counter()
        x = refs[i].load(lo, hi) if multi else dX.row_panel(i)[lo:hi]
        read_s += time.perf_counter() - t0
        host.append((x, yrefs[i].load(lo, hi)))
    put_s, k3_ms, dev = 0.0, 0.0, app.backend.device
    for x, yh in host:
        _mesh_sync(torch)
        t0 = time.perf_counter()
        xd = torch.from_numpy(x).to(dev)
        _mesh_sync(torch)
        put_s += time.perf_counter() - t0
        pa = streaming.augment_ones(xd)
        yd = torch.from_numpy(yh).to(dev)
        del xd
        k3_ms += time_ms(lambda: cuda_newton.stats(pa, yd, beta, "logistic")) \
            if DEVICE == "cuda" else 0.0
        del pa, yd
    da = dX.shape[1] + 1
    packed = torch.zeros(da * (da + 1), device=dev)
    ar_ms = _mesh_time_ms(torch, lambda: dist.all_reduce(packed))
    x, yh = host[0]
    p = torch.from_numpy(x).to(dev)
    kernels = (_kernels_at(torch, p, streaming.augment_ones(p),
                           torch.from_numpy(yh).to(dev), beta)
               if DEVICE == "cuda" else {})
    mine = {"host_read_s": read_s, "host_to_device_s": put_s,
            "k3_one_shot_ms_all_panels": k3_ms, "rows": sum(
                x.shape[0] for x, _ in host)}
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, mine)
    return {"per_rank": per, "all_reduce_g_h_ms": ar_ms,
            "all_reduce_bytes": 4 * packed.numel(),
            "panel_kernels_rank0": kernels,
            "panel_rows": int(p.shape[0])}


def _mesh_ooc_kmeans64(torch, local, rows, k_iters):
    """In-core Lloyd's from the first-panel seeding on ``local`` (the
    whole X on a world-1 mesh): phase 8's reference."""
    from nums_tpu_torch.models import cluster

    sample = local[:rows]
    centers = cluster._plusplus_init(KM_K, KM_SEED, sample,
                                     cluster._row_sq_norms(sample), False)
    xx = cluster._row_sq_norms(local)
    for _ in range(k_iters):
        _, sums, counts = cluster._assign_stats(local, centers, KM_K, xx)
        centers, _ = cluster._update(centers, sums, counts)
    return centers


def _mesh_ooc(torch, app, X, y, ref, root, say, head, t_phase=None):
    """Phase 16's steps on this rank (the module docstring lists them) on
    X (its row blocks the panels) and labels y, against ``ref``: phase 15's
    (or this X's) in-core gram ("gram"), fitted β ("beta") and Newton
    iterations ("iterations"). The phase's seconds count from ``t_phase``
    (default: now). Returns the phase's totals."""
    import torch.distributed as dist

    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.application import _ooc_y_getter
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.grid import ArrayGrid
    from nums_tpu_torch.core.ops import cuda_gram, streaming, summa
    from nums_tpu_torch.models import cluster
    from nums_tpu_torch.models.decomposition import PCA
    from nums_tpu_torch.models.glms import LogisticRegression

    t_phase = time.perf_counter() if t_phase is None else t_phase
    world, rank = dist.get_world_size(), dist.get_rank()
    n, d = X.shape
    rows = X.block_shape[0]
    local = X.raw.to_local()
    (r0, r1), _ = app.backend.region((n, d), X.raw.placements)
    steps = {}
    out = {"phase": "mesh_ooc", **head, "panel_rows": rows,
           "panels": -(-n // rows), "steps": steps}

    def step(name, fn):
        return _ooc_mesh_step(torch, steps, name, fn)

    # 1. The checkpoint: each rank writes its own block files.
    ck = os.path.join(root, "ckpt")
    written = []
    undo = _counting_block_writes(written)
    try:
        step("write_fs", lambda: app.write_fs(X, ck))
    finally:
        undo()
    blocks = [None] * world
    dist.all_gather_object(blocks, sorted(written))
    out["block_files_written_per_rank"] = [len(b) for b in blocks]
    names = [f for b in blocks for f in b]
    assert len(names) == len(set(names)), "a block written twice"
    if world > 1:
        assert out["block_files_written_per_rank"] == [1] * world, blocks
    back, _ = step("read_fs", lambda: app.read_fs(ck))
    same = _bits_same(torch, back.raw.to_local(), local)
    assert _all_true(torch, same), "read_fs is not write_fs's X bit for bit"
    del back
    _mesh_free(torch)
    report, _ = step("verify_fs", lambda: app.verify_fs(ck, repair=True))
    reports = [None] * world
    dist.all_gather_object(reports, report)
    assert report["ok"] and all(r == report for r in reports), reports
    flags, _ = step("delete_fs", lambda: app.delete_fs(ck))
    assert bool(flags[0]) and not os.path.exists(ck), flags
    out["checkpoint"] = {"bitwise": True, "blocks": report["blocks"],
                         "same_report_on_every_rank": True}

    # 2. The spill of X and of y (y in X's row blocks).
    yb = BlockArray.from_torch(y.data, block_shape=(rows,),
                               backend=app.backend)
    (dX, dy), _ = step("spill", lambda: (
        app.spill(X, os.path.join(root, "X")),
        app.spill(yb, os.path.join(root, "y"))))
    npanels, my_rows = _panels_with_rows(app, dX)
    assert dX.num_row_panels == dy.num_row_panels == out["panels"], dX
    share = my_rows * d * 4

    # 3. gram_ooc: K1 on this rank's rows of each panel.
    G, c = step("gram_ooc", lambda: _whole(app.gram_ooc(dX).data))
    assert c["gram"] == npanels and c["gram_weighted"] == 0, c
    assert c["newton_stats"] == 0, c
    if world > 1:
        assert steps["gram_ooc"]["panel_bytes_read_per_rank"][rank] == share
    _, out["gram_rel_err_vs_in_core"] = rel_err(G, ref["gram"])
    assert out["gram_rel_err_vs_in_core"] <= FULL_REL, out
    g64 = _gram64(local)
    dist.all_reduce(g64)
    _, out["gram_rel_err_vs_f64"] = rel_err(G, g64)
    del G

    # 4. The logistic fit on the DiskArray: K3 one-shot on this rank's
    # rows of each panel, one all-reduce of g and H a pass.
    passes = []
    newton_update = streaming.newton_update
    streaming.newton_update = (
        lambda *a: passes.append(1) or newton_update(*a))
    try:
        model, c = step("fit", lambda: LogisticRegression(**FIT).fit(dX, dy))
    finally:
        streaming.newton_update = newton_update
    it = len(passes)
    out["fit_iterations"], out["in_core_iterations"] = it, ref["iterations"]
    assert it == ref["iterations"], (it, ref["iterations"])
    assert c["newton_stats"] == c["newton_stage"] == c["gram_weighted"] \
        == it * npanels, (c, it, npanels)
    assert c["gram"] == 0, c
    beta = torch.cat([_whole(model.coef_.data),
                      _whole(model.intercept_.data)[None]])
    _, out["beta_rel_err_vs_in_core"] = rel_err(beta, ref["beta"])
    assert out["beta_rel_err_vs_in_core"] <= BETA_REL, out

    # 5. One statistics pass with the Newton gate off (K2) against K3's.
    beta_half = cuda_gram.round_bf16(0.5 * beta)
    y_at = _ooc_y_getter(dX, dy)
    (g3, h3), c = step("k3_pass", lambda: _mesh_stats_pass(
        torch, app, dX, y_at, beta_half, "logistic"))
    assert c["newton_stats"] == c["gram_weighted"] == npanels, c
    gate, settings.newton_kernel = settings.newton_kernel, "0"
    try:
        (g2, h2), c = step("k2_pass", lambda: _mesh_stats_pass(
            torch, app, dX, y_at, beta_half, "logistic"))
    finally:
        settings.newton_kernel = gate
    assert c["gram_weighted"] == npanels and c["gram"] == 0, c
    assert c["newton_stats"] == c["newton_stage"] == 0, c
    _, out["k2_vs_k3_g_rel_err"] = rel_err(g2, g3)
    _, out["k2_vs_k3_h_rel_err"] = rel_err(h2, h3)
    assert out["k2_vs_k3_g_rel_err"] <= FULL_REL, out
    assert out["k2_vs_k3_h_rel_err"] <= STATS_BF16_REL, out
    del g2, h2, g3, h3

    # 6. linear_regression_ooc (K1) against float64 normal equations.
    w = torch.from_numpy(np.random.default_rng(MESH_NT_SEED).standard_normal(
        d).astype(np.float32)).to(local.device)
    yl = local @ w
    by_lin = BlockArray(app.backend.from_local(
        yl, (n,), streaming.row_placements(app.backend.mesh)),
        ArrayGrid((n,), (rows,), "float32"), app.backend)
    theta, c = step("linear_regression_ooc", lambda: _whole(
        app.linear_regression_ooc(dX, by_lin).data))
    assert c["gram"] == npanels and c["gram_weighted"] == 0, c
    mu64, b64 = _rows64(torch, local, yl)
    dist.all_reduce(mu64)
    dist.all_reduce(b64)
    mu64 /= n
    theta64 = torch.linalg.solve(g64, b64)
    _, out["linear_regression_rel_err_vs_f64"] = rel_err(theta, theta64)
    assert out["linear_regression_rel_err_vs_f64"] <= BETA_REL, out
    del by_lin, yl, theta

    # 7. tsqr_r_ooc: each rank's R of its rows, the R's stacked and
    # factored once; RᵀR against the float64 gram.
    R, c = step("tsqr_r_ooc", lambda: _whole(app.tsqr_r_ooc(dX).data))
    assert not any(c.values()), c
    _, out["tsqr_rtr_rel_err_vs_f64"] = rel_err(R.double().T @ R.double(),
                                                g64)
    assert out["tsqr_rtr_rel_err_vs_f64"] <= MESH_OOC_TSQR_REL, out
    del R

    # 8. predict_ooc (host, each rank its rows) against the in-core
    # predict of the same model.
    pred, c = step("predict_ooc", lambda: model.predict_ooc(
        dX, out=os.path.join(root, "pred")))
    assert not any(c.values()), c
    labels = model.predict(X)
    mine = summa.local_part(labels.raw, summa.row_layout(X.raw)).cpu()
    got = np.concatenate([pred.row_panel(i)
                          for i in range(pred.num_row_panels)])[r0:r1]
    assert got.shape == (r1 - r0,), got.shape
    wrong = int(_sum_all(torch, float((got != mine.numpy()).sum())))
    out["predict_mismatch_share"] = wrong / n
    assert out["predict_mismatch_share"] <= OOC_LABEL_MISMATCH, out
    del labels, mine, got

    # 9. PCA(16): the moments of one streamed pass (K1), the transform.
    pca, c = step("pca_fit", lambda: PCA(n_components=OOC_COMPONENTS).fit(
        dX))
    assert c["gram"] == npanels and c["gram_weighted"] == 0, c
    cov = (g64 - n * torch.outer(mu64, mu64)) / (n - 1)
    ev_ref = torch.linalg.eigvalsh(cov).flip(0)[:OOC_COMPONENTS]
    _, out["pca_explained_variance_rel_err_vs_f64"] = rel_err(
        _whole(pca.explained_variance_.data), ev_ref)
    assert out["pca_explained_variance_rel_err_vs_f64"] <= BF16_REL, out
    comps = _whole(pca.components_.data)
    eye = torch.eye(OOC_COMPONENTS, device=comps.device)
    out["pca_orthonormal_abs_err"] = float((comps @ comps.T - eye).abs().max())
    assert out["pca_orthonormal_abs_err"] <= ORTHONORMAL_ABS, out
    del cov
    T, c = step("pca_transform", lambda: pca.transform(
        dX, out=os.path.join(root, "pcaT")))
    assert not any(c.values()), c
    k = min(MESH_OOC_CHECK_ROWS, r1 - r0)
    if k:
        start = dX.grid.grid_slices[0][r0 // rows][0]
        got = torch.from_numpy(T.row_panel(r0 // rows)[r0 - start:r0 - start
                                                       + k]).double()
        want = (local[:k].double() - _whole(pca.mean_.data).double()) @ \
            comps.double().T
        _, t_rel = rel_err(got.to(want.device), want)
    else:
        t_rel = 0.0
    out["pca_transform_rel_err_vs_f64"] = _all_max(torch, t_rel)
    assert out["pca_transform_rel_err_vs_f64"] <= OOC_TRANSFORM_REL, out
    del pca, comps, T

    # 10. KMeans(16): two passes at tol 0 and the inertia pass, then
    # predict_ooc; no kernel.
    km, c = step("kmeans_fit", lambda: cluster.KMeans(
        n_clusters=KM_K, max_iter=KM_OOC_ITER, tol=0.0, seed=KM_SEED).fit(dX))
    assert not any(c.values()) and km.n_iter_ == KM_OOC_ITER, (c, km.n_iter_)
    centers = km._centers_data()
    km_labels, c = step("kmeans_predict_ooc", lambda: km.predict_ooc(
        dX, out=os.path.join(root, "km_labels")))
    assert not any(c.values()), c
    assert km_labels.shape == (n,), km_labels.shape
    if world == 1:
        want = _mesh_ooc_kmeans64(torch, local, rows, KM_OOC_ITER)
        _, out["kmeans_centers_rel_err_vs_in_core"] = rel_err(centers, want)
        assert out["kmeans_centers_rel_err_vs_in_core"] <= KM_OOC_REL, out
    elif rank == 0:  # held by the parent to a world-1 fit of the file
        np.save(os.path.join(root, "km_centers.npy"), centers.cpu().numpy())
    del km, km_labels, centers

    out["pass_parts"] = _mesh_ooc_pass_parts(torch, app, dX, dy, beta_half)
    del dX, dy, model
    _mesh_free(torch)
    totals = {}
    for s in steps.values():
        for key, v in s["launches_per_card"][rank].items():
            totals[key] = totals.get(key, 0) + v
    out["launches"] = totals
    out["seconds"] = _all_max(torch, time.perf_counter() - t_phase)
    out["deadline_s"] = MESH_OOC_DEADLINE_S
    assert out["seconds"] <= MESH_OOC_DEADLINE_S, out["seconds"]
    say(out)
    return out


def _sum_all(torch, value):
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_mesh_device(torch))
    dist.all_reduce(t)
    return float(t.item())


def _higgs_rows(lo, hi, beta):
    """Rows [lo, hi) of phase 10's table (label, then the features) in
    float32, drawn again from the chunks' seeds."""
    parts = []
    for i, start in enumerate(range(0, HIGGS_ROWS, HIGGS_CHUNK_ROWS)):
        stop = min(start + HIGGS_CHUNK_ROWS, HIGGS_ROWS)
        if stop <= lo or start >= hi:
            continue
        x, y = _higgs_chunk(i, stop - start, beta)
        table = np.concatenate([y[:, None], x], axis=1)
        parts.append(table[max(lo, start) - start:min(hi, stop) - start])
    if not parts:
        return np.zeros((0, HIGGS_FEATURES + 1), np.float32)
    return np.concatenate(parts).astype(np.float32)


def _mesh_ooc_io(torch, app, root, say, head):
    """Phase 16's I/O at realistic size on every rank: a 2.5M x 1000 slice
    of X (10 GB) written with two replicas, rank 0's block corrupted by the
    last rank and read back through the failover, the collective
    ``verify_fs(repair=True)`` (one report on every rank) and
    ``delete_fs``; the slice through ``s3://`` on the file-backed fake in
    a shared directory; phase 10's HIGGS text (11M x 29) through
    ``read_csv`` (each rank parses its rows) and, where pyarrow is
    installed, a Parquet file of it through ``read_parquet``, bitwise."""
    import importlib.util

    import torch.distributed as dist

    import nums_tpu_torch
    from nums_tpu_torch.core import multiprocess

    world, rank = dist.get_world_size(), dist.get_rank()
    steps = {}
    out = {"phase": "mesh_ooc_io", **head,
           "slice_shape": [MESH_OOC_SLICE, D_FULL], "steps": steps}

    def step(name, fn):
        return _ooc_mesh_step(torch, steps, name, fn)

    S = _draw_mesh_x(torch, app, MESH_OOC_SLICE, D_FULL)
    sl = S.raw.to_local()
    path = os.path.join(root, "slice")
    step("write_fs_replicas", lambda: app.write_fs(S, path, replicas=2))
    multiprocess.barrier("pre-corrupt")
    if rank == world - 1:  # rank 0's block, from another rank
        victim = os.path.join(path, "block_0_0.npy")
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)  # past the header
            f.write(b"\xde\xad\xbe\xef" * 64)
    multiprocess.barrier("post-corrupt")
    back, _ = step("read_fs_verify", lambda: app.read_fs(path, verify=True))
    assert _all_true(torch, _bits_same(torch, back.raw.to_local(), sl)), \
        "failover read"
    del back
    _mesh_free(torch)
    report, _ = step("verify_fs_repair", lambda: app.verify_fs(
        path, repair=True))
    reports = [None] * world
    dist.all_gather_object(reports, report)
    assert all(r == report for r in reports), reports
    assert [f for _, f in report["bad"]] == ["block_0_0.npy"], report
    assert report["repaired"] and not report["unrecoverable"], report
    out["repair_report"] = {k: report[k] for k in ("blocks", "copies", "ok")}
    out["repair_report"]["bad"] = [f for _, f in report["bad"]]
    flags, _ = step("delete_fs", lambda: app.delete_fs(path))
    assert bool(flags[0]) and not os.path.exists(path), flags

    fake = os.path.join(root, "fake_s3")
    os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"] = fake
    try:
        if rank == 0:
            app.fs._s3_client().create_bucket(Bucket="bkt")
        multiprocess.barrier("bucket")
        step("write_s3", lambda: nums_tpu_torch.api.write(S, "s3://bkt/x"))
        back, _ = step("read_s3", lambda: nums_tpu_torch.api.read(
            "s3://bkt/x"))
        assert _all_true(torch, _bits_same(torch, back.raw.to_local(), sl))
        del back
        step("delete_s3", lambda: nums_tpu_torch.api.delete("s3://bkt/x"))
        multiprocess.barrier("deleted")
        left = [k for k in os.listdir(os.path.join(fake, "bkt"))
                if not k.startswith("#")]
        assert not left, left
    finally:
        del os.environ["NUMS_TPU_TORCH_FAKE_S3_DIR"]
    del S, sl
    _mesh_free(torch)

    # HIGGS: rank 0 writes the text, every rank parses its rows.
    beta_true = (0.3 * np.random.default_rng(HIGGS_SEED).standard_normal(
        HIGGS_FEATURES)).astype(np.float32)
    csv = os.path.join(root, "higgs.csv")
    writers = max(1, min(HIGGS_WRITERS, os.cpu_count() or 1))
    multiprocess.stage("higgs-csv", "the HIGGS text", lambda: _higgs_write_csv(
        csv, beta_true, writers), only0=True)
    out["csv_bytes"] = os.path.getsize(csv)
    Xc, _ = step("read_csv", lambda: nums_tpu_torch.api.read_csv(csv))
    (c0, c1), _ = app.backend.region(tuple(Xc.shape), Xc.raw.placements)
    want = _higgs_rows(c0, c1, beta_true)
    got = Xc.raw.to_local().cpu().numpy()
    assert Xc.shape == (HIGGS_ROWS, HIGGS_FEATURES + 1), Xc.shape
    assert _all_true(torch, _bits_equal(got, want)), "read_csv rows"
    rows = [None] * world
    dist.all_gather_object(rows, [int(c0), int(c1)])
    out["csv_rows_per_rank"] = rows
    del Xc, got
    if importlib.util.find_spec("pyarrow") is None:
        out["parquet"] = "not run: pyarrow is not installed here"
    else:
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq_path = os.path.join(root, "higgs.parquet")

        def write_parquet():
            with pq.ParquetWriter(pq_path, pa.schema(
                    [(f"c{j}", pa.float32())
                     for j in range(HIGGS_FEATURES + 1)])) as w:
                for lo in range(0, HIGGS_ROWS, 1_000_000):
                    t = _higgs_rows(lo, min(lo + 1_000_000, HIGGS_ROWS),
                                    beta_true)
                    w.write_table(pa.table({f"c{j}": t[:, j] for j in
                                            range(t.shape[1])}))

        multiprocess.stage("higgs-parquet", "the HIGGS Parquet file",
                           write_parquet, only0=True)
        Xp, _ = step("read_parquet", lambda: nums_tpu_torch.api.read_parquet(
            pq_path))
        (c0, c1), _ = app.backend.region(tuple(Xp.shape), Xp.raw.placements)
        got = Xp.raw.to_local().cpu().numpy()
        assert _all_true(torch, _bits_equal(got, _higgs_rows(
            c0, c1, beta_true))), "read_parquet rows"
        out["parquet"] = "bitwise"
        del Xp
    say(out)
    return out


def _mesh_ooc_refs(torch, app, n, d, rows):
    """X of ``n`` rows drawn from phase 4's seed in row blocks of ``rows``,
    its planted labels, and the in-core references of phase 16: the gram
    (K1 on the mesh), the fused fit's β and its iterations (K3's
    launches)."""
    from nums_tpu_torch.models.glms import LogisticRegression

    X = app.random_state(RANDOM_KNOWN["seed"]).normal(
        shape=(n, d), block_shape=(rows, d), dtype=np.float32)
    y, _ = planted_labels(torch, app, X)
    G = _whole((X.T @ X).data).clone()
    _reset_counts()
    model = LogisticRegression(**FIT).fit(X, y)
    iters = _counts()["newton_stats"]
    beta = torch.cat([_whole(model.coef_.data),
                      _whole(model.intercept_.data)[None]])
    return X, y, {"gram": G, "beta": beta, "iterations": iters}


def phase_mesh_ooc(torch, smi, app):
    """Phase 16 in the full run: on the world-1 mesh of phase 15, X of
    MESH_OOC_N1 rows in MESH_OOC_PANELS1 panels (4 GB) spilled under
    ``settings.data_dir`` and streamed back through the mesh branch of
    ``ooc_put`` and the folds (``_mesh_ooc``); removed at the end."""
    import shutil
    import tempfile

    from nums_tpu_torch.core import settings

    n, d = MESH_OOC_N1, D_FULL
    rows = -(-n // MESH_OOC_PANELS1)
    os.makedirs(settings.data_dir, exist_ok=True)
    free = shutil.disk_usage(settings.data_dir).free
    need = 4.0 * n * d + MESH_OOC_MARGIN_BYTES
    assert free >= need, (
        f"phase 16 needs {need / 1e9:.0f} GB free under {settings.data_dir};"
        f" {free / 1e9:.1f} GB are free")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_ooc-",
                            dir=settings.data_dir)
    head = {"world": 1, "shape": [n, d], "cluster_shape": [1, 1],
            "nvidia_smi": smi, "data_dir_free_bytes": free}
    try:
        X, y, ref = _mesh_ooc_refs(torch, app, n, d, rows)
        out = _mesh_ooc(torch, app, X, y, ref, root, emit, head)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _mesh_ooc_cards(torch, app, X, y, ref, cfg, say, head):
    """Phase 16 under --mesh-only, on this rank: the I/O at realistic
    size, then ``_mesh_ooc`` on phase 15's X and against its in-core
    results (or, where the free disk cut N, on X drawn again at the cut
    and against its own)."""
    root = cfg["ooc_root"]
    t_phase = time.perf_counter()
    _mesh_ooc_io(torch, app, root, say, head)
    n = cfg["ooc_n"]
    if n != X.shape[0]:
        del X, y
        _mesh_free(torch)
        X, y, ref = _mesh_ooc_refs(torch, app, n, X.shape[1],
                                   -(-n // app.backend.num_devices))
    return _mesh_ooc(torch, app, X, y, ref, root, say,
                     {**head, "shape": [n, X.shape[1]]}, t_phase)


def _mesh_ooc_world1_kmeans(torch, root, world):
    """The parent's last step of phase 16: KMeans(16) on the DiskArray the
    ranks spilled, on a world-1 mesh of the first card alone, two passes at
    tol 0, its centers held to the ranks' (KM_OOC_REL)."""
    import tempfile

    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager
    from nums_tpu_torch.models import cluster

    saved = application_manager._instance
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=1, rank=0)
        try:
            app = application_manager.create(
                device=None if DEVICE == "cuda" else DEVICE, backend="mesh")
            application_manager.set_instance(app)
            dX = app.open_fs(os.path.join(root, "X"))
            t0 = time.perf_counter()
            km = cluster.KMeans(n_clusters=KM_K, max_iter=KM_OOC_ITER,
                                tol=0.0, seed=KM_SEED).fit(dX)
            secs = time.perf_counter() - t0
            want = torch.from_numpy(np.load(os.path.join(
                root, "km_centers.npy")))
            _, rel = rel_err(km._centers_data().cpu(), want)
            app.backend.shutdown()
        finally:
            application_manager.set_instance(saved)
            if dist.is_initialized():
                dist.destroy_process_group()
    assert rel <= KM_OOC_REL, rel
    out = {"phase": "mesh_ooc_kmeans_world1", "ranks": world,
           "shape": list(dX.shape), "fit_s": secs,
           "centers_rel_err_vs_ranks": rel, "tolerance": KM_OOC_REL}
    emit(out)
    return out


# Phase 17, masks and the data-dependent ops on the mesh: filter, encode
# and fit. In the full run on phase 15's world-1 mesh and its X, every
# result bit for bit the serial backend's; with --masks-only on every card
# at 10M x 1000.
MASK_KEEP = 0.7              # the skewed filter keeps t >= 0.7 N, the last
                             # 30% of the rows by time
MASK_C_SEED = 1717           # the categorical column c = floor(U(0, 1000))
MASK_CATEGORIES = 1000
MASK_ISIN = 50               # isin(c, every 20th category)
MASK_EDGES = 32              # digitize's quantile edges
MASK_HIST_BINS = 64
MASK_SAMPLE_ROWS = 64        # filtered rows a rank holds to X's, bitwise
MASK_DEADLINE_S = 600.0      # every rank exits 0 within, or the run fails


def _mask_columns(torch, app, X):
    """t = arange(N) and c = floor(U(0, 1000)) as int64, laid out as X's
    rows (one block of X's rows each)."""
    import nums_tpu_torch.numpy as nps

    n, rows = X.shape[0], X.block_shape[0]
    t = app.arange((n,), (rows,))
    u = app.random_state(MASK_C_SEED).uniform(
        0.0, float(MASK_CATEGORIES), shape=(n,), block_shape=(rows,),
        dtype=np.float32)
    return t, nps.floor(u).astype(np.int64)


def _masks_steps(torch, app, X, y, t, c):
    """Every step of phase 17 on X's app (the mesh, or the serial backend
    with the same tensors): (results by step, seconds and bytes sent by
    step, launches of the gram, fit and predict). A column is taken as a
    one-column block reshaped in place, so that it stays laid out as X's
    rows."""
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core import multiprocess
    from nums_tpu_torch.models.glms import LogisticRegression

    n, rows = X.shape[0], X.block_shape[0]
    res, info = {}, {}

    def col(j):
        return X[:, j:j + 1].reshape(n, block_shape=(rows,))

    def step(name, fn):
        before = multiprocess.EXCHANGED["bytes_sent"]
        res[name], secs = _mesh_seconds(torch, fn)
        info[name] = {"seconds": secs, "bytes_sent": multiprocess.EXCHANGED[
            "bytes_sent"] - before}
        return res[name]

    even = step("mask_even", lambda: col(0) > 0)
    step("filter_even", lambda: X[even])
    skew = step("mask_skewed", lambda: t >= int(MASK_KEEP * n))
    Xs = step("filter_skewed", lambda: X[skew])
    ys = step("labels_skewed", lambda: y[skew])
    step("unique", lambda: nps.unique(c, return_counts=True,
                                      return_inverse=True))
    cats = np.arange(0, MASK_CATEGORIES, MASK_CATEGORIES // MASK_ISIN)
    step("isin", lambda: nps.isin(c, app.array(cats, block_shape=(
        len(cats),))))
    c1 = col(1)
    # the edges: quantiles of the column read to the host (40 MB at 10M)
    edges = step("quantile_edges", lambda: app.array(np.quantile(
        np.asarray(c1.get()), np.linspace(0.0, 1.0, MASK_EDGES)).astype(
            np.float32), block_shape=(MASK_EDGES,)))
    bins = step("digitize", lambda: nps.digitize(c1, edges))
    step("bincount", lambda: nps.bincount(bins))
    step("histogram", lambda: nps.histogram(col(2), MASK_HIST_BINS))
    step("where", lambda: app.where(even))
    _reset_counts()
    step("gram", lambda: Xs.T @ Xs)
    model = step("fit", lambda: LogisticRegression(**FIT).fit(Xs, ys))
    step("predict", lambda: model.predict(Xs))
    launches = _counts()
    res["beta"] = torch.cat([model.coef_.data, model.intercept_.data[None]])
    res["col0"], res["col1"], res["col2"] = col(0), c1, col(2)
    return res, info, launches


def _local(a):
    """A BlockArray's tensor on this process (a DTensor's own part)."""
    from nums_tpu_torch.core.ops import mesh_ops

    t = a.raw
    return t.to_local() if mesh_ops.is_dtensor(t) else t


def _serial_twin(backend, a):
    """A BlockArray of the serial backend on the same tensor as a world-1
    mesh array (its one part is the whole)."""
    from nums_tpu_torch.core.array.blockarray import BlockArray

    return BlockArray.from_torch(_local(a), a.block_shape, backend)


def _same_results(torch, got, ref):
    """The names of the results of two ``_masks_steps`` that are not
    equal bit for bit (tensors, tuples of them, BlockArrays)."""
    from nums_tpu_torch.core.ops import mesh_ops

    def flat(v):
        if isinstance(v, (tuple, list)):
            return [x for e in v for x in flat(e)]
        if hasattr(v, "raw"):
            return [_local(v)]
        return [v.to_local() if mesh_ops.is_dtensor(v) else v]

    differ = []
    for name, value in got.items():
        if name == "fit":
            continue  # the model: its beta and predictions are compared
        a, b = flat(value), flat(ref[name])
        if len(a) != len(b) or not all(
                x.dtype == z.dtype and x.shape == z.shape and bool(
                    torch.equal(x.detach(), z.detach()))
                for x, z in zip(a, b)):
            differ.append(name)
    return differ


def phase_masks(torch, smi, app, X, y):
    """Phase 17 in the full run, on phase 15's world-1 mesh and its X: the
    steps of ``_masks_steps`` on the mesh and again on the serial backend
    with the same tensors, every result bit for bit equal; K1 once and K3
    ``max_iter`` times in each."""
    from nums_tpu_torch.core import application_manager

    t_phase = time.perf_counter()
    mesh_app = application_manager._instance
    serial = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE)
    t, c = _mask_columns(torch, app, X)
    got, info, launches = _masks_steps(torch, app, X, y, t, c)
    application_manager.set_instance(serial)
    try:
        twins = [_serial_twin(serial.backend, a) for a in (X, y, t, c)]
        ref, serial_info, serial_launches = _masks_steps(torch, serial,
                                                         *twins)
    finally:
        application_manager.set_instance(mesh_app)
    differ = _same_results(torch, got, ref)
    assert not differ, ("mesh vs serial", differ)
    want = {"gram": 1, "gram_weighted": FIT["max_iter"], "newton_stage": 1,
            "newton_stats": FIT["max_iter"]}
    assert launches == want and serial_launches == want, (launches,
                                                          serial_launches)
    out = {"phase": "masks", "world": 1, "shape": list(X.shape),
           "nvidia_smi": smi, "launches": launches,
           "steps": info, "serial_steps": serial_info,
           "rows": {"even": int(got["filter_even"].shape[0]),
                    "skewed": int(got["filter_skewed"].shape[0])},
           "bitwise_vs_serial": sorted(got),
           "seconds": time.perf_counter() - t_phase}
    del got, ref, twins
    _mesh_free(torch)
    emit(out)
    return out


def _row_sums64(torch, x, chunk=MESH_CHUNK):
    return torch.cat([x[i:i + chunk].double().sum(dim=1)
                      for i in range(0, x.shape[0], chunk)]) if x.shape[0] \
        else torch.zeros(0, dtype=torch.float64, device=x.device)


def _masks_cards(torch, cfg):
    """--masks-only on this rank: X of 10M x 1000 fp32 drawn on the
    (cards, 1) mesh from phase 4's seed, t, c and the planted labels, then
    ``_masks_steps``, every output held to numpy's or float64's (the
    module docstring lists the checks); rank 0 prints the phase's line."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager
    from nums_tpu_torch.core.ops import random_ops, threefry

    world, rank = dist.get_world_size(), dist.get_rank()
    n, d = cfg["n"], cfg["d"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if rank == 0 else (lambda obj: print(json.dumps(obj)))
    head = {"world": world, "shape": [n, d], "cluster_shape": [world, 1]}
    X, draw_secs = _mesh_seconds(torch, lambda: _draw_mesh_x(
        torch, app, n, d))
    y, _ = planted_labels(torch, app, X)
    t, c = _mask_columns(torch, app, X)
    res, info, launches = _masks_steps(torch, app, X, y, t, c)
    checks = {}
    # the integer outputs against numpy's on the host columns
    c_h = np.asarray(c.get())
    col0, col1, col2 = (np.asarray(res[k].get())
                        for k in ("col0", "col1", "col2"))
    vals, inv, cnt = (np.asarray(a.get()) for a in res["unique"])
    nv, ninv, ncnt = np.unique(c_h, return_inverse=True, return_counts=True)
    assert np.array_equal(vals, nv) and np.array_equal(cnt, ncnt)
    assert np.array_equal(inv, ninv.reshape(c_h.shape))
    cats = np.arange(0, MASK_CATEGORIES, MASK_CATEGORIES // MASK_ISIN)
    assert np.array_equal(np.asarray(res["isin"].get()), np.isin(c_h, cats))
    edges = np.asarray(res["quantile_edges"].get())
    bins = np.asarray(res["digitize"].get())
    assert np.array_equal(bins, np.digitize(col1, edges))
    assert np.array_equal(np.asarray(res["bincount"].get()),
                          np.bincount(bins))
    hist, hedges = (np.asarray(a.get()) for a in res["histogram"])
    assert hedges[0] == col2.min() and hedges[-1] == col2.max()
    assert np.array_equal(hist, np.histogram(col2, bins=hedges)[0])
    (where,) = res["where"]
    even_idx = np.nonzero(col0 > 0)[0]
    assert np.array_equal(np.asarray(where.get()), even_idx)
    checks["integer_outputs_equal_numpy"] = [
        "unique", "inverse", "counts", "isin", "digitize", "bincount",
        "histogram", "where"]
    # the filtered rows: float64 row sums equal X's at their positions,
    # and a sample of rows bit for bit a serial draw of those positions
    sums = _row_sums64(torch, X.raw.to_local())
    counts = [None] * world
    dist.all_gather_object(counts, int(sums.shape[0]))
    every = [torch.empty(k, dtype=sums.dtype, device=sums.device)
             for k in counts]
    dist.all_gather(every, sums)
    sums_all = torch.cat(every)
    key = threefry.fold_in(threefry.seed_key(RANDOM_KNOWN["seed"], False),
                           RANDOM_KNOWN["counter"])
    skew0 = int(MASK_KEEP * n)
    for name, positions in (
            ("filter_even", lambda a, b: torch.from_numpy(
                even_idx[a:b]).to(sums.device)),
            ("filter_skewed", lambda a, b: torch.arange(
                skew0 + a, skew0 + b, device=sums.device))):
        F = res[name]
        local = F.raw.to_local()
        (a, b), _ = app.backend.region(tuple(F.shape), F.raw.placements)
        pos = positions(a, b)
        assert torch.equal(_row_sums64(torch, local), sums_all[pos]), name
        pick = np.unique(np.linspace(0, max(b - a - 1, 0),
                                     MASK_SAMPLE_ROWS).astype(np.int64)) \
            if b > a else []
        for i in pick:
            r = int(pos[int(i)])
            row = random_ops.jr_normal(key, (n, d), torch.float32,
                                       local.device,
                                       flat_range=(r * d, (r + 1) * d))
            assert torch.equal(local[int(i)], row), (name, r)
        rows_here = [None] * world
        dist.all_gather_object(rows_here, (a, b))
        checks[name + "_rows_per_rank"] = rows_here
    # the fit on the skewed rows: K1 once, K3 max_iter times a card; G
    # and beta against float64 on each rank's rows
    want = {"gram": 1, "gram_weighted": FIT["max_iter"], "newton_stage": 1,
            "newton_stats": FIT["max_iter"]}
    assert launches == want, launches
    Xs = res["filter_skewed"].raw.to_local()
    ys = _rows_like(app, res["labels_skewed"], res["filter_skewed"])
    g64 = _gram64(Xs)
    dist.all_reduce(g64)
    _, gram_rel = rel_err(res["gram"].data.full_tensor(), g64)
    assert gram_rel <= MESH_GRAM_REL, gram_rel
    beta64 = _newton64(torch, Xs, ys, FIT["max_iter"])
    _, beta_rel = rel_err(res["beta"].full_tensor(), beta64)
    assert beta_rel <= BETA_REL, beta_rel
    beta32 = res["beta"].full_tensor()
    pred = _rows_like(app, res["predict"], res["filter_skewed"])
    mine = ((Xs @ beta32[:-1] + beta32[-1]) > 0).to(pred.dtype)
    mismatch = _sum_all(torch, float((pred != mine).sum())) / max(
        1, int(res["filter_skewed"].shape[0]))
    assert mismatch <= OOC_LABEL_MISMATCH, mismatch
    # warm times (CUDA events, the slowest rank): the filters without
    # the first all-to-all's set-up, and K1 and the fit on 750k rows a card
    # beside phase 15's on 2.5M
    from nums_tpu_torch.models.glms import LogisticRegression

    even, skew = res["mask_even"], res["mask_skewed"]
    Xs_ba, ys_ba = res["filter_skewed"], res["labels_skewed"]
    warm = {"filter_even_ms": _mesh_time_ms(torch, lambda: X[even]),
            "filter_skewed_ms": _mesh_time_ms(torch, lambda: X[skew]),
            "gram_ms": _mesh_time_ms(torch, lambda: Xs_ba.T @ Xs_ba),
            "fit_ms": _mesh_time_ms(torch, lambda: LogisticRegression(
                **FIT).fit(Xs_ba, ys_ba), reps=1)}
    peak = _mesh_peak(torch)
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    # X whole on one card would take X's bytes alone
    assert max(peaks) < 4.0 * n * d or DEVICE != "cuda", (
        peaks, "a card held X whole")
    sent = [None] * world
    dist.all_gather_object(sent, {k: v["bytes_sent"] for k, v in
                                  info.items() if v["bytes_sent"]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "masks", **head, "draw_seconds": draw_secs,
         "steps": info, "warm": warm, "bytes_sent_per_rank": sent,
         "launches_per_rank": launches, "gram_rel_err_vs_f64": gram_rel,
         "gram_tolerance": MESH_GRAM_REL, "beta_rel_err_vs_f64": beta_rel,
         "beta_tolerance": BETA_REL, "predict_mismatch_share": mismatch,
         "rows": {"even": int(res["filter_even"].shape[0]),
                  "skewed": int(res["filter_skewed"].shape[0])},
         "distinct_categories": int(vals.shape[0]), **checks,
         "peak_bytes_per_card": peaks, "nvidia_smi_per_card": smi})


def _rows_like(app, v, F):
    """This rank's part of the 1-D ``v`` on the rows that it holds of the
    2-D ``F`` (the same length)."""
    from nums_tpu_torch.core.ops import mesh_ops

    want = mesh_ops.rows_only(F.raw.placements)
    return app.backend.rebox(v.raw, want).to_local()


def phase_masks_cards(torch, smi):
    """--masks-only: one process per visible card, as --mesh-only spawns
    them, each running ``_masks_cards``; fails unless every rank exits 0
    before ``MASK_DEADLINE_S``. Returns the number of ranks."""
    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    cfg = {"n": MESH_N, "d": D_FULL, "device": DEVICE,
           "deadline": MASK_DEADLINE_S, "out_dir": out_dir, "root": root,
           "entry": "_masks_cards"}
    emit({"phase": "masks_start", "world": world, "nvidia_smi": smi,
          "shape": [cfg["n"], cfg["d"]]})
    t0 = time.perf_counter()
    codes = _spawn_ranks(world, cfg)
    assert codes == [0] * world, ("masks ranks' exit codes", codes)
    emit({"phase": "masks_done", "world": world, "exit_codes": codes,
          "seconds": time.perf_counter() - t0})
    return world


def _spawn_ranks(world, cfg):
    """One ``_mesh_rank`` process per card (``spawn``, a file:// rendezvous
    under a temporary directory) until all end, one fails or the deadline
    passes; returns their exit codes."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_mesh_rank, args=(r, world, init, cfg))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + cfg["deadline"]
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs
                      if p.exitcode is not None and p.exitcode != 0]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [p.exitcode for p in procs]


# -- Phase 18: the in-core mesh path (mesh_core) --------------------------
# The models, the facade, device index arrays, the distributed
# factorizations and the sharded draws on the mesh. With --mesh-core-only
# on every card at phase 15's 10M x 1000 (MC_FULL); in the full run on
# phase 15's world-1 mesh at 2.5M x 1000 (MC_WORLD1).
MC_FULL = {"n": MESH_N, "fact_n": 16384, "vec": 100_000_000,
           "idx": 1_000_000, "gbt_n": GBDT_N, "draw_rows": MESH_N}
MC_WORLD1 = {"n": N_FULL, "fact_n": 4096, "vec": 25_000_000,
             "idx": 250_000, "gbt_n": GBDT_N // 4, "draw_rows": N_FULL // 4}
MC_FACT_SMALL = 1000         # also held to a float64 host factorization
MC_FACT_PANEL = 512          # the SPD matrix's row block: the panel width
MC_TAPS = 1001               # correlate/convolve's kernel
MC_COLS = 8                  # the quantiles' columns
MC_REPEAT_COLS = 64          # repeat(X[:, :64], 2, axis=0)
MC_KMEANS = dict(n_clusters=16, max_iter=5, tol=0.0, seed=0)
MC_PCA = 16
MC_ADMM = dict(solver="admm", penalty="l1", tol=1e-7, max_iter=40)
MC_ADMM_ROWS_C = 4000.0      # C = 4000 / n: the same l1 weight a row at
                             # any n, light enough to keep most of the
                             # planted coefficients (40 / n zeroes them all)
MC_ADMM_RHO_ROWS = 0.25      # admm_rho = n / 4, the logistic loss's
                             # curvature at β = 0 for unit columns
MC_ADMM_CHECK = dict(rows=250_000, max_iter=240)  # where the l1 ADMM fit of
                             # all 1000 columns reaches its optimum: on X it
                             # stalls (residual balancing leaves ρ ~1000x
                             # below the curvature; PERF.md), and its KKT
                             # there is recorded, not held
MC_KKT_REL = 1e-2            # l1 optimality, float64, of the fp32 ADMM fit
MC_NEWTON64_STEPS = 30       # the float64 references' iterations (at most)
MC_LABEL_MISMATCH = 1e-4     # float32 fits' labels vs float64 argmins
MC_QUANT_REL = 1e-6          # float32 order statistics, float64 weights
MC_SCAN_REL = FULL_REL       # float32 cumsum of 25M a card vs float64
MC_CONV_REL = 1e-5           # float32 conv1d vs float64, of max|ref|
MC_SUM_REL = 1e-4            # Σ out = Σ x · Σ k (mode "full") in float32
MC_CONV_CHECK = 1 << 21      # interior outputs a rank held to float64
MC_RESID_REL = 1e-3          # ‖LLᵀ − A‖, ‖A inv(A) − I‖, ‖Ax − b‖ (fp32)
MC_F64_REL = 1e-4            # n = 1000 vs a float64 host factorization
MC_DRAW_CHECK_ROWS = 64      # each shard's first rows vs a serial draw
MC_DEADLINE_S = 900.0        # every rank exits 0 within, or the run fails


def _col_sums64(torch, x, w=None, chunk=MESH_CHUNK):
    """Σ_i w_i·x_i (w = 1 without it) in float64, a chunk of rows at a
    time (X in float64 whole would take twice its bytes)."""
    out = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        out += c.sum(0) if w is None else c.T @ w[i:i + chunk].double()
    return out


def _mc_local(a):
    from nums_tpu_torch.core.ops import mesh_ops

    t = a.raw if hasattr(a, "raw") else a
    return t.to_local() if mesh_ops.is_dtensor(t) else t


def _mc_sum(torch, value, op="sum"):
    """A float summed (or maxed) over every rank, in float64."""
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_mesh_device(torch))
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op])
    return float(t.item())


def _mc_rows(app, a):
    """(r0, r1) of the rows this rank holds of ``a``."""
    return app.backend.region(tuple(a.shape), a.raw.placements)[0]


def _mc_whole(t):
    """A small model array's tensor whole on this rank."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _aug64(torch, x, i, chunk=MESH_CHUNK):
    """Rows [i, i + chunk) of ``x`` in float64 with a column of ones (the
    intercept's) after the last."""
    c = x[i:i + chunk].double()
    return torch.cat([c, c.new_ones((c.shape[0], 1))], dim=1)


def _newton64(torch, x, yl, lam):
    """The l2-penalized logistic optimum (Σ NLL + ½ Σ λ_j β_j², the
    intercept last) in float64 by Newton's method from β = 0: each step's
    g and H summed over this rank's rows ``x`` (labels ``yl``) a chunk at
    a time and all-reduced."""
    import torch.distributed as dist

    b = torch.zeros(x.shape[1] + 1, dtype=torch.float64, device=x.device)
    for _ in range(MC_NEWTON64_STEPS):
        g = torch.zeros_like(b)
        H = torch.zeros((b.shape[0], b.shape[0]), dtype=b.dtype,
                        device=b.device)
        for i in range(0, x.shape[0], MESH_CHUNK):
            c = _aug64(torch, x, i)
            mu = torch.sigmoid(c @ b)
            g += c.T @ (mu - yl[i:i + MESH_CHUNK])
            H += c.T @ (c * (mu * (1.0 - mu))[:, None])
            del c
        dist.all_reduce(g)
        dist.all_reduce(H)
        step = torch.linalg.solve(H + torch.diag(lam), g + lam * b)
        b -= step
        if float(step.abs().max()) <= 1e-10 * float(b.abs().max()):
            break
    return b


def _gram_aug64(g64, s1, n):
    """[X 1]ᵀ[X 1] from the all-reduced XᵀX ``g64``, column sums ``s1``
    and row count ``n``."""
    d = g64.shape[0]
    G = g64.new_zeros((d + 1, d + 1))
    G[:d, :d] = g64
    G[:d, d] = s1
    G[d, :d] = s1
    G[d, d] = n
    return G


def _lasso64(torch, G, xty, ysum, lam, steps=1000):
    """The Lasso optimum (½‖y − [X 1]β‖² + Σ λ_j |β_j|) in float64 by
    FISTA on the all-reduced moments: [X 1]ᵀ[X 1] ``G`` (``_gram_aug64``),
    Xᵀy ``xty`` and Σy ``ysum``."""
    q = torch.cat([xty, xty.new_tensor([ysum])])
    step = 1.0 / float(torch.linalg.eigvalsh(G)[-1])
    b = torch.zeros_like(q)
    v, t = b, 1.0
    for _ in range(steps):
        u = v - step * (G @ v - q)
        new = torch.sign(u) * (u.abs() - step * lam).clamp_min(0)
        t_new = (1.0 + (1.0 + 4.0 * t * t) ** 0.5) / 2.0
        v = new + ((t - 1.0) / t_new) * (new - b)
        b, t = new, t_new
    return b


def _l1_kkt64(torch, x, yl, z, lam):
    """The l1-penalized logistic fit ``z``'s optimality in float64: the
    loss's gradient g summed over every rank's rows, then the largest of
    |g_j + λ_j sign(z_j)| (z_j ≠ 0) and max(|g_j| − λ_j, 0) (z_j = 0),
    over the largest λ, and the z of the coordinate that holds it."""
    import torch.distributed as dist

    g = torch.zeros_like(z)
    for i in range(0, x.shape[0], MESH_CHUNK):
        c = _aug64(torch, x, i)
        g += c.T @ (torch.sigmoid(c @ z) - yl[i:i + MESH_CHUNK])
        del c
    dist.all_reduce(g)
    v = torch.where(z != 0, (g + lam * torch.sign(z)).abs(),
                    (g.abs() - lam).clamp_min(0))
    return {"kkt_rel_to_lambda": float(v.max() / lam.max()),
            "kkt_worst_z": float(z[v.argmax()])}


def _mc_admm_check(torch, app, step, m, d):
    """The l1 logistic ADMM fit held to its optimality conditions where
    it converges: X's first ``m`` rows, every column (drawn again on the
    mesh, laid out over every rank, with their planted labels), the same
    λ and ρ a row, ``MC_ADMM_CHECK``'s steps."""
    from nums_tpu_torch.models.glms import LogisticRegression

    Xm = _draw_mesh_x(torch, app, m, d)
    ym, _ = planted_labels(torch, app, Xm)
    fit = step("admm_converged", lambda: LogisticRegression(
        C=MC_ADMM_ROWS_C / m, admm_rho=MC_ADMM_RHO_ROWS * m, solver="admm",
        penalty="l1", tol=MC_ADMM["tol"],
        max_iter=MC_ADMM_CHECK["max_iter"]).fit(Xm, ym))
    z = torch.cat([_mc_whole(fit.coef_.data), _mc_whole(
        fit.intercept_.data).reshape(1)]).double()
    res = _l1_kkt64(torch, _mc_local(Xm), _rows_like(app, ym, Xm).double(),
                    z, _mc_whole(fit._lambda_vec.data).double())
    assert res["kkt_rel_to_lambda"] <= MC_KKT_REL, ("admm", m, res)
    assert int((z[:-1] != 0).sum()), "admm: every coefficient is 0"
    return {**res, "rows": m, "steps": MC_ADMM_CHECK["max_iter"],
            "nonzeros": int((z[:-1] != 0).sum())}


def _mc_models(torch, app, X, y, cfg, step, out, serial):
    """KMeans, PCA, the lbfgs, admm and Lasso fits and the GBT classifier
    on the mesh, X whole: KMeans, PCA and the three GLM solvers held to
    float64 references on the mesh, the GBT to numpy tables (and, on a
    world-1 mesh, KMeans and the GBT to the serial backend's fits on the
    same tensors, bit for bit)."""
    import torch.distributed as dist

    from nums_tpu_torch.models.cluster import KMeans
    from nums_tpu_torch.models.decomposition import PCA
    from nums_tpu_torch.models.glms import Lasso, LogisticRegression
    from nums_tpu_torch.models.trees import GBTClassifier

    x = _mc_local(X)
    n = X.shape[0]
    # KMeans: labels and inertia against float64 argmins of its centers
    km = step("kmeans", lambda: KMeans(**MC_KMEANS).fit(X))
    c64 = km.cluster_centers_.data.full_tensor().double()
    lab = _mc_local(km.labels_)
    miss, inertia64 = 0, 0.0
    for i in range(0, x.shape[0], MESH_CHUNK):
        xc = x[i:i + MESH_CHUNK].double()
        d2 = (xc * xc).sum(1, keepdim=True) - 2 * xc @ c64.T + (
            c64 * c64).sum(1)[None]
        a = d2.argmin(1)
        miss += int((a != lab[i:i + MESH_CHUNK]).sum())
        inertia64 += float(d2.gather(1, a[:, None]).clamp_min(0).sum())
    share = _mc_sum(torch, miss) / n
    inertia64 = _mc_sum(torch, inertia64)
    krel = abs(km.inertia_ - inertia64) / inertia64
    assert share <= MC_LABEL_MISMATCH, ("kmeans labels", share)
    assert krel <= KM_REL * 10, ("kmeans inertia", krel)
    out["kmeans"] = {"label_mismatch_share": share,
                     "inertia_rel_err_vs_f64": krel,
                     "n_iter": km.n_iter_}
    if serial is not None:
        with _mc_current(serial):
            ks = KMeans(**MC_KMEANS).fit(_serial_twin(serial.backend, X))
        assert torch.equal(ks.cluster_centers_.data,
                           km.cluster_centers_.data.full_tensor())
        out["kmeans"]["bitwise_vs_serial"] = True
    del km, lab
    # PCA of X, every column: singular values against the float64
    # centered gram's
    pca = step("pca", lambda: PCA(MC_PCA).fit(X))
    g64 = _gram64(x)
    s1 = _col_sums64(torch, x)
    dist.all_reduce(g64)
    dist.all_reduce(s1)
    mu = s1 / n
    cov = g64 - n * torch.outer(mu, mu)
    ev = torch.linalg.eigvalsh(cov).flip(0)[:MC_PCA].clamp_min(0).sqrt()
    _, srel = rel_err(pca.singular_values_.data.full_tensor(), ev)
    comps = pca.components_.data.full_tensor().double()
    ortho = float((comps @ comps.T - torch.eye(
        MC_PCA, dtype=torch.float64, device=comps.device)).abs().max())
    assert srel <= LA_R_REL, ("pca singular values", srel)
    assert ortho <= ORTHONORMAL_ABS * 10, ("pca components", ortho)
    out["pca"] = {"singular_values_rel_err_vs_f64": srel,
                  "orthonormal_max_abs_err": ortho,
                  "columns": int(X.shape[1])}
    del pca, cov, comps, mu
    # lbfgs, logistic ADMM and Lasso on X, every column, each held to a
    # float64 reference of its own problem built from all-reduced float64
    # sums of each rank's rows: lbfgs to Newton's optimum, Lasso to
    # FISTA's on the gram, the ADMM fit to the l1 optimality conditions
    d = X.shape[1]
    G = _gram_aug64(g64, s1, n)
    w = np.zeros(d, dtype=np.float32)
    w[:20] = 1.0
    ylin = X @ app.array(w, block_shape=(d,)) + app.scalar(0.5)
    fits = {
        "lbfgs": (lambda: LogisticRegression(solver="lbfgs", **LBFGS), y),
        "admm": (lambda: LogisticRegression(
            C=MC_ADMM_ROWS_C / n, admm_rho=MC_ADMM_RHO_ROWS * n,
            **MC_ADMM), y),
        "lasso": (lambda: Lasso(**LASSO), ylin)}
    for name, (make, yy) in fits.items():
        m = step(name, lambda make=make, yy=yy: make().fit(X, yy))
        z = torch.cat([_mc_whole(m.coef_.data), _mc_whole(
            m.intercept_.data).reshape(1)]).double()
        lam = _mc_whole(m._lambda_vec.data).double()
        yl = _rows_like(app, yy, X).double()
        nonzeros = int((z[:-1] != 0).sum())
        assert nonzeros, (name, "every coefficient is 0: nothing compared")
        if name == "lbfgs":
            ref = _newton64(torch, x, yl, lam)
            res = {"beta_rel_err_vs_f64_newton": rel_err(z, ref)[1]}
        elif name == "lasso":
            xty = _col_sums64(torch, x, yl)
            dist.all_reduce(xty)
            ref = _lasso64(torch, G, xty, _mc_sum(torch, float(yl.sum())),
                           lam)
            res = {"beta_rel_err_vs_f64_fista": rel_err(z, ref)[1]}
        else:  # recorded, not held: at this size the fit stalls
            res = _l1_kkt64(torch, x, yl, z, lam)
        if name != "admm":
            (e,) = res.values()
            assert e <= SOLVER_REL, (name, res)
        out[name] = {**res, "nonzeros": nonzeros, "columns": d}
        del m
    del ylin, g64, s1, G
    out["admm"]["held"] = _mc_admm_check(torch, app, step, min(
        MC_ADMM_CHECK["rows"], n), d)
    # GBT classifier at benchmark_models.py's data, split over the ranks
    gn = cfg["gbt_n"]
    rows = -(-gn // app.backend.num_devices)
    gx, _, gy = _gbdt_data(torch, gn, GBDT_D)
    Xg = _mc_from_whole(app, gx, (rows, GBDT_D))
    yg = _mc_from_whole(app, gy, (rows,))
    del gx, gy
    gb = step("gbt", lambda: GBTClassifier(**GBDT).fit(Xg, yg))
    pred = gb.predict(Xg)
    acc = _mc_sum(torch, float((_mc_local(pred) == _rows_like(
        app, yg, Xg)).sum())) / gn
    raw = gb._raw_predict(Xg)
    ref = torch.from_numpy(_tables_numpy(_mc_local(Xg).cpu().numpy(), gb))
    assert acc >= GBDT_ACC, ("gbt accuracy", acc)
    assert torch.equal(raw.cpu(), ref), "gbt raw scores vs numpy tables"
    out["gbt"] = {"accuracy": acc, "rows": gn,
                  "raw_scores_equal_numpy_tables": True}
    if serial is not None:
        with _mc_current(serial):
            twin = GBTClassifier(**GBDT).fit(
                _serial_twin(serial.backend, Xg),
                _serial_twin(serial.backend, yg))
        assert _same_trees(torch, twin, gb), "gbt vs serial"
        out["gbt"]["bitwise_vs_serial"] = True


@contextlib.contextmanager
def _mc_current(app):
    """``app`` the current application for the enclosed calls."""
    from nums_tpu_torch.core import application_manager

    saved = application_manager._instance
    application_manager.set_instance(app)
    try:
        yield app
    finally:
        application_manager.set_instance(saved)


def _mc_from_whole(app, t, block_shape):
    """A tensor that every rank computed whole, as a BlockArray: each rank
    keeps its own box (no communication)."""
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.grid import ArrayGrid
    from nums_tpu_torch.core.array import utils as array_utils

    grid = ArrayGrid(tuple(t.shape), block_shape,
                     array_utils.to_dtype_name(t.dtype))
    return BlockArray(t, grid, app.backend)


def _mc_edges(torch, lv, a, b, w):
    """Every rank's (a, b, its first ``w`` values, its last ``w``) of a
    vector of which this rank holds ``lv`` = positions [a, b), in float64
    (one all-gather of 2 + 2w values a rank)."""
    import torch.distributed as dist

    buf = lv.new_zeros((2 + 2 * w,))
    buf[0], buf[1] = a, b
    head = lv[:w]
    tail = lv[max(0, lv.shape[0] - w):]
    buf[2:2 + head.shape[0]] = head
    buf[2 + w:2 + w + tail.shape[0]] = tail
    got = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(got, buf)
    out = []
    for g in got:
        ea, eb = int(g[0]), int(g[1])
        hn, tn = min(w, eb - ea), min(w, eb - ea)
        out.append(((ea, g[2:2 + hn]), (eb - tn, g[2 + w:2 + w + tn])))
    return out


def _mc_window(torch, lv, a, b, edges, lo, hi, n):
    """Positions [lo, hi) of the whole vector in float64, zeros outside
    [0, n): from this rank's part ``lv`` (positions [a, b)) and every
    rank's edges (``_mc_edges``); fails unless every position is known."""
    out = lv.new_zeros((hi - lo,))
    known = torch.zeros(hi - lo, dtype=torch.bool, device=lv.device)
    known[:max(0, min(hi, 0) - lo)] = True
    known[max(0, n - lo):] = True
    parts = [(a, lv)] + [p for pair in edges for p in pair]
    for start, vals in parts:
        s0, s1 = max(lo, start), min(hi, start + vals.shape[0])
        if s1 > s0:
            out[s0 - lo:s1 - lo] = vals[s0 - start:s1 - start]
            known[s0 - lo:s1 - lo] = True
    assert bool(known.all()), ("halo not covered", lo, hi)
    return out


def _mc_facade(torch, app, X, cfg, step, out):
    """Quantiles of 8 columns, the cumsum of a long vector, repeat and pad
    of X, correlate/convolve in the three modes; each held to numpy or to
    float64 on each rank's part."""
    import nums_tpu_torch.numpy as nps

    n, d = X.shape
    rows = X.block_shape[0]
    cols = X[:, :MC_COLS]
    host = np.asarray(cols.get())
    q = [0.01, 0.5, 0.99]
    med_all = step("median_none", lambda: nps.median(cols))
    q_rows = step("quantile_rows", lambda: nps.quantile(cols, q, axis=0))
    q_all = step("quantile_none", lambda: nps.quantile(cols, q))
    h64 = host.astype(np.float64)
    errs = {}
    for name, got, want in (
            ("median_none", med_all, np.median(h64)),
            ("quantile_rows", q_rows, np.quantile(h64, q, axis=0)),
            ("quantile_none", q_all, np.quantile(h64, q))):
        _, errs[name] = rel_err(torch.from_numpy(np.asarray(
            got.get(), dtype=np.float64)), torch.from_numpy(
                np.asarray(want)))
        assert errs[name] <= MC_QUANT_REL, (name, errs[name])
    del host, h64
    out["quantiles"] = {"rel_err_vs_numpy_f64": errs}
    # the long vector: cumsum (axis=None), correlate/convolve
    m = cfg["vec"]
    vb = -(-m // app.backend.num_devices)
    v = app.random_state(MASK_C_SEED + 1).normal(
        shape=(m,), block_shape=(vb,), dtype=np.float32)
    cs = step("cumsum_none", lambda: nps.cumsum(v))
    lv = _mc_local(v).double()
    (a, b) = _mc_rows(app, v)
    tot = torch.zeros(app.backend.num_devices, dtype=torch.float64,
                      device=lv.device)
    me = app.backend.coords().index(
        tuple(int(c) for c in app.backend.mesh.get_coordinate()))
    tot[me] = lv.sum()
    import torch.distributed as dist

    dist.all_reduce(tot)
    ref = torch.cumsum(lv, 0) + tot[:me].sum()
    _, srel = rel_err(_mc_local(cs), ref)
    srel = _mc_sum(torch, srel, "max")
    assert srel <= MC_SCAN_REL, ("cumsum", srel)
    out["cumsum"] = {"rel_err_vs_f64": srel, "length": m}
    del cs, ref
    k = app.random_state(MASK_C_SEED + 2).normal(
        shape=(MC_TAPS,), block_shape=(MC_TAPS,), dtype=np.float32)
    kk = _mc_local(k).double()
    edges = _mc_edges(torch, lv, a, b, 4 * MC_TAPS)
    conv = {}
    for op in ("correlate", "convolve"):
        for mode in ("valid", "same", "full"):
            res = step(f"{op}_{mode}", lambda op=op, mode=mode: getattr(
                nps, op)(v, k, mode=mode))
            local = _mc_local(res)
            o0, o1 = _mc_rows(app, res)
            ker = kk.conj() if op == "correlate" else kk.flip(0)
            pad = {"valid": 0, "same": MC_TAPS // 2,
                   "full": MC_TAPS - 1}[mode]
            # this rank's first and last 2(m - 1) outputs, whose inputs
            # cross into the neighbours' parts (the halo), and the first
            # MC_CONV_CHECK whose inputs all lie in its own part
            lo = max(o0, a + pad)
            edge = 2 * (MC_TAPS - 1)
            pieces = [(o0, min(o1, o0 + edge)), (max(o0, o1 - edge), o1),
                      (lo, min(o1, b + pad - MC_TAPS + 1,
                               lo + MC_CONV_CHECK))]
            err, scale = 0.0, 0.0
            for s0, s1 in pieces:
                if s1 <= s0:
                    continue
                xw = _mc_window(torch, lv, a, b, edges, s0 - pad,
                                s1 - pad + MC_TAPS - 1, m)
                want = torch.nn.functional.conv1d(
                    xw[None, None], ker[None, None])[0, 0]
                err = max(err, float((local[s0 - o0:s1 - o0].double()
                                      - want).abs().max()))
                scale = max(scale, float(want.abs().max()))
            err = _mc_sum(torch, err, "max") / _mc_sum(torch, scale, "max")
            assert err <= MC_CONV_REL, (op, mode, err)
            conv[f"{op}_{mode}"] = {"halo_and_interior_rel_err_vs_f64": err,
                                    "length": int(res.shape[0])}
            if mode == "full":
                total = _mc_sum(torch, float(local.double().sum()))
                want = _mc_sum(torch, float(lv.sum())) * float(kk.sum())
                rel = abs(total - want) / max(abs(want), 1e-30)
                assert rel <= MC_SUM_REL, (op, "sum", rel)
                conv[f"{op}_{mode}"]["sum_rel_err"] = rel
            del res, local
    out["correlate_convolve"] = conv
    del v, lv
    # repeat and pad of X
    xl = _mc_local(X)
    r0, r1 = _mc_rows(app, X)
    part = X[:, :MC_REPEAT_COLS]
    rep = step("repeat_rows", lambda: nps.repeat(part, 2, axis=0))
    rl = _mc_local(rep)
    p0, p1 = _mc_rows(app, rep)
    src = torch.arange(p0, p1, device=rl.device) // 2
    own = (src >= r0) & (src < r1)
    assert torch.equal(rl[own], xl[src[own] - r0, :MC_REPEAT_COLS]), \
        "repeat"
    del rep, rl, part
    padded = step("pad_rows", lambda: nps.pad(X, ((1, 2), (0, 0))))
    pl = _mc_local(padded)
    p0, p1 = _mc_rows(app, padded)
    src = torch.arange(p0, p1, device=pl.device) - 1
    own = (src >= r0) & (src < r1)
    assert torch.equal(pl[own], xl[src[own] - r0]), "pad"
    edge = (src < 0) | (src >= n)
    assert not bool(pl[edge].any()), "pad: the new rows are zero"
    out["repeat_pad"] = {"bitwise_own_rows": True,
                         "padded_shape": list(padded.shape)}
    del padded, pl


def _mc_index(torch, app, X, cfg, step, out):
    """Device index arrays on X: idx of ``cfg["idx"]`` rows drawn by the
    sharded ``integers`` (each shard the serial draw's box), X[idx] read
    (row sums equal X's at idx), a mask beside a device column index read
    (equal to the same elements by two device arrays), and X[idx] = 2·X[idx]
    written (X's row sums doubled at idx, the others unchanged)."""
    import torch.distributed as dist

    from nums_tpu_torch.core.ops import random_ops, threefry

    n, d = X.shape
    m = cfg["idx"]
    rs = app.random_state(MASK_C_SEED + 3)
    key = threefry.fold_in(rs._key, rs._counter + 1)
    idx = step("integers", lambda: rs.integers(
        0, n, shape=(m,), block_shape=(-(-m // app.backend.num_devices),)))
    a, b = _mc_rows(app, idx)
    whole = random_ops.integers(key, (m,), torch.int64, "cpu", False, 0, n,
                                False)
    assert torch.equal(_mc_local(idx).cpu(), whole[a:b]), "integers"
    sums = _row_sums64(torch, _mc_local(X))
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(sums.shape[0]))
    every = [torch.empty(c, dtype=sums.dtype, device=sums.device)
             for c in counts]
    dist.all_gather(every, sums)
    sums_all = torch.cat(every)
    rows = step("read_rows", lambda: X[idx])
    ridx = app.backend.rebox(idx.raw, _mc_rows_only(rows)).to_local()
    assert torch.equal(_row_sums64(torch, _mc_local(rows)),
                       sums_all[ridx.to(sums_all.device)]), "X[idx] rows"
    # a device mask beside a device column index
    # a column as a one-column block reshaped in place: laid out as X's
    # rows (X[:, 0] is one block, whole on every rank)
    mask = X[:, 0:1].reshape(n, block_shape=(X.block_shape[0],)) > 0
    cnt = int(mask.sum())
    cols = app.random_state(MASK_C_SEED + 4).integers(
        0, d, shape=(cnt,), block_shape=(-(-cnt // app.backend.num_devices),))
    got = step("read_mask_index", lambda: X[mask, cols])
    # the reference: each rank's own rows of the mask and their columns
    # read locally, then all-gathered in row order
    xl = _mc_local(X)
    r0, _ = _mc_rows(app, X)
    mine = torch.nonzero(xl[:, 0] > 0).reshape(-1)
    c0, _ = _mc_rows(app, cols)
    every = _mc_gather_parts(torch, torch.tensor(
        [r0, mine.shape[0]], device=mine.device))
    before = sum(int(c) for s0, c in every if s0 < r0)
    whole_cols = _mc_gather_vec(torch, _mc_local(cols), c0)
    ref = _mc_gather_vec(torch, xl[mine, whole_cols[
        before:before + mine.shape[0]].to(mine.device)], before)
    g0, g1 = _mc_rows(app, got)
    assert torch.equal(_mc_local(got), ref[g0:g1]), "mask with index"
    del got, ref, cols, mask, whole_cols
    out["index"] = {"rows": m, "mask_rows": cnt,
                    "read_rows_sums_equal": True,
                    "integers_equal_serial_box": True}
    return idx, sums_all, rows


def _mc_gather_parts(torch, t):
    """Every rank's small 1-D tensor ``t`` (one all-gather), as lists."""
    import torch.distributed as dist

    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t.contiguous())
    return [g.tolist() for g in got]


def _mc_gather_vec(torch, part, start):
    """The whole vector of which this rank holds ``part`` from position
    ``start``: every rank's part all-gathered (padded to the longest) and
    laid end to end in position order."""
    import torch.distributed as dist

    meta = _mc_gather_parts(torch, torch.tensor(
        [start, part.shape[0]], device=part.device))
    top = max(1, max(c for _, c in meta))
    buf = part.new_zeros((top,))
    buf[:part.shape[0]] = part
    got = [torch.empty_like(buf) for _ in meta]
    dist.all_gather(got, buf)
    order = sorted(range(len(meta)), key=lambda r: meta[r][0])
    return torch.cat([got[r][:meta[r][1]] for r in order])


def _mc_rows_only(a):
    from nums_tpu_torch.core.ops import mesh_ops

    return mesh_ops.rows_only(a.raw.placements)


def _mc_write(torch, app, X, idx, sums_all, rows, step, out):
    """X[idx] = 2·X[idx] (last: it changes X)."""
    v = rows * app.scalar(2.0)
    step("write_rows", lambda: X.__setitem__(idx, v))
    after = _row_sums64(torch, _mc_local(X))
    r0, r1 = _mc_rows(app, X)
    hit = torch.zeros(r1 - r0, dtype=torch.bool, device=after.device)
    il = _mc_local(idx).to(after.device)
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, il.cpu())
    for part in every:
        p = part.to(after.device)
        p = p[(p >= r0) & (p < r1)] - r0
        hit[p] = True
    want = torch.where(hit, 2.0 * sums_all[r0:r1], sums_all[r0:r1])
    assert torch.equal(after, want), "X[idx] = v"
    out["index"]["write_rows_sums_equal"] = True


def _mc_spd(torch, app, nf):
    """A = BᵀB/m + I at n = ``nf`` (fp32), B of nf x nf drawn on the mesh,
    laid out by MC_FACT_PANEL-row blocks (sharded by rows): the gram under
    ``auto`` (its partial grams reduce-scattered), never whole."""
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.grid import ArrayGrid

    rows = -(-nf // app.backend.num_devices)
    B = app.random_state(LA_SEED).normal(shape=(nf, nf), block_shape=(
        rows, nf), dtype=np.float32)
    settings.collective_matmul = "auto"
    try:
        G = B.T @ B
    finally:
        settings.collective_matmul = "0"
    del B
    grid = ArrayGrid((nf, nf), (min(MC_FACT_PANEL, nf), nf), "float32")
    data = app.backend.rebox(G.raw, app.backend.sharding_for_grid(grid))
    A = BlockArray(data, grid, app.backend) * app.scalar(1.0 / nf)
    return A + app.eye((nf, nf), grid.block_shape, dtype=np.float32)


def _mc_factor(torch, app, X, y, cfg, step, out):
    """ridge_regression of X in column blocks (RᵀR sharded; K1 in it),
    then cholesky, posdef_solve and inv of a sharded SPD matrix at
    ``cfg["fact_n"]`` held by residuals on the mesh, and at n = 1000 to a
    float64 host factorization."""
    import torch.distributed as dist

    n, d = X.shape
    Xc = X.reshape(X.shape, block_shape=(X.block_shape[0], d // 4))
    yr = (X @ app.array(np.linspace(-1.0, 1.0, d).astype(np.float32),
                        block_shape=(d,)))
    lam = float(n) * 1e-3
    _reset_counts()
    theta = step("ridge", lambda: app.ridge_regression(Xc, yr, lam))
    ridge_launches = _counts()
    assert ridge_launches["gram"] >= 1, ("K1 in ridge", ridge_launches)
    x = _mc_local(X)
    g64 = _gram64(x)
    q64 = _col_sums64(torch, x, _rows_like(app, yr, X))
    dist.all_reduce(g64)
    dist.all_reduce(q64)
    want = torch.linalg.solve(g64 + lam * torch.eye(
        d, dtype=torch.float64, device=g64.device), q64)
    _, rrel = rel_err(theta.data.full_tensor(), want)
    assert rrel <= LA_RIDGE_BF16_REL, ("ridge", rrel)
    out["ridge"] = {"theta_rel_err_vs_f64": rrel,
                    "launches": ridge_launches, "lambda": lam,
                    "gram_placements": "sharded"}
    del g64, Xc
    res = {}
    for nf in (cfg["fact_n"], MC_FACT_SMALL):
        A = _mc_spd(torch, app, nf)
        rhs = app.array(np.linspace(1.0, 2.0, nf).astype(np.float32),
                        block_shape=(min(MC_FACT_PANEL, nf),))
        tag = "" if nf == cfg["fact_n"] else "_small"
        L = step("cholesky" + tag, lambda: app.cholesky(A))
        xs = step("posdef_solve" + tag, lambda: app.posdef_solve(A, rhs))
        Ai = step("inv" + tag, lambda: app.inv(A))
        amax = float(_mc_sum(torch, float(_mc_local(A).abs().max()),
                             "max"))
        llt = L @ L.T
        e_chol = _mc_sum(torch, float((_mc_local(llt) - _mc_local(
            A)).abs().max()), "max") / amax
        ax = A @ xs
        e_solve = _mc_sum(torch, float((_mc_local(ax) - _mc_local(
            rhs)).abs().max()), "max") / float(np.abs(np.linspace(
                1.0, 2.0, nf)).max())
        ai = A @ Ai
        eye = app.eye((nf, nf), A.block_shape, dtype=np.float32)
        e_inv = _mc_sum(torch, float((_mc_local(ai) - _mc_local(
            eye)).abs().max()), "max")
        del llt, ax, ai, eye
        for name, e in (("cholesky", e_chol), ("posdef_solve", e_solve),
                        ("inv", e_inv)):
            assert e <= MC_RESID_REL, (name, nf, e)
        res[str(nf)] = {"cholesky_residual": e_chol,
                        "posdef_solve_residual": e_solve,
                        "inv_residual": e_inv}
        if nf == MC_FACT_SMALL:
            a64 = np.asarray(A.get(), dtype=np.float64)
            b64 = np.linspace(1.0, 2.0, nf)
            errs = {
                "cholesky": rel_err(torch.from_numpy(np.asarray(L.get())),
                                    torch.from_numpy(
                                        np.linalg.cholesky(a64)))[1],
                "posdef_solve": rel_err(torch.from_numpy(np.asarray(
                    xs.get())), torch.from_numpy(np.linalg.solve(
                        a64, b64)))[1],
                "inv": rel_err(torch.from_numpy(np.asarray(Ai.get())),
                               torch.from_numpy(np.linalg.inv(a64)))[1]}
            for name, e in errs.items():
                assert e <= MC_F64_REL, (name, "vs float64", e)
            res[str(nf)]["rel_err_vs_f64_host"] = errs
        del A, L, xs, Ai
        _mesh_free(torch)
    out["factorizations"] = res


def _mc_draws(torch, app, cfg, step, out):
    """integers (int32) and gamma at ``cfg["draw_rows"]`` x 1000, sharded:
    each shard's first rows bit for bit a serial draw of that box."""
    from nums_tpu_torch.core.ops import random_ops, threefry

    nr, d = cfg["draw_rows"], D_FULL
    rows = -(-nr // app.backend.num_devices)
    checks = {}
    for name, draw, serial in (
            ("integers", lambda rs: rs.integers(
                -5, 1000, shape=(nr, d), block_shape=(rows, d),
                dtype=np.int32),
             lambda key, box: random_ops.integers(
                 key, (nr, d), torch.int32, _mesh_device(torch), False,
                 -5, 1000, False, region=box)),
            ("gamma", lambda rs: rs.gamma(
                2.0, 1.5, shape=(nr, d), block_shape=(rows, d),
                dtype=np.float32),
             lambda key, box: random_ops.sample_region(
                 "gamma", key, (nr, d), box, torch.float32,
                 _mesh_device(torch), False, 2.0, 1.5))):
        rs = app.random_state(LA_SEED + 1)
        key = threefry.fold_in(rs._key, rs._counter + 1)
        arr = step("draw_" + name, lambda: draw(rs))
        local = _mc_local(arr)
        r0, r1 = _mc_rows(app, arr)
        k = min(MC_DRAW_CHECK_ROWS, r1 - r0)
        ref = serial(key, ((r0, r0 + k), (0, d)))
        assert torch.equal(local[:k], ref), name
        checks[name] = {"rows_checked_per_rank": k,
                        "mean": _mc_sum(torch, float(local.double().sum()))
                        / (nr * d)}
        del arr, local
        _mesh_free(torch)
    out["draws"] = checks


def _mesh_core_steps(torch, app, X, y, cfg, say, head, serial=None):
    """Every step of phase 18 on this rank (the mesh of X's app): each
    step's seconds (host clock after a barrier, the slowest rank's), the
    bytes this rank sent through collectives (and by all-to-all alone),
    its peak and the kernel launches in it;
    every check on every rank. Returns the phase's record."""
    from nums_tpu_torch.core import multiprocess

    info, out = {}, {}

    def step(name, fn):
        sent = multiprocess.SENT["bytes"]
        moved = multiprocess.EXCHANGED["bytes_sent"]
        _reset_counts()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res, secs = _mesh_seconds(torch, fn)
        info[name] = {"seconds": secs,
                      "bytes_sent": multiprocess.SENT["bytes"] - sent,
                      "all_to_all_bytes_sent":
                      multiprocess.EXCHANGED["bytes_sent"] - moved,
                      "launches": {k: v for k, v in _counts().items() if v},
                      "peak_bytes": _mesh_peak(torch)}
        return res

    t0 = time.perf_counter()
    _mc_models(torch, app, X, y, cfg, step, out, serial)
    _mesh_free(torch)
    _mc_facade(torch, app, X, cfg, step, out)
    _mesh_free(torch)
    idx, sums_all, rows = _mc_index(torch, app, X, cfg, step, out)
    _mc_factor(torch, app, X, y, cfg, step, out)
    _mc_draws(torch, app, cfg, step, out)
    _mc_write(torch, app, X, idx, sums_all, rows, step, out)
    del idx, sums_all, rows
    _mesh_free(torch)
    # warm times of a few steps (CUDA events, the slowest rank)
    import nums_tpu_torch.numpy as nps

    cols = X[:, :MC_COLS]
    A = _mc_spd(torch, app, cfg["fact_n"])
    warm = {"quantile_rows_ms": _mesh_time_ms(torch, lambda: nps.quantile(
        cols, [0.01, 0.5, 0.99], axis=0), reps=1),
            "cholesky_ms": _mesh_time_ms(torch, lambda: app.cholesky(A),
                                         reps=1),
            "inv_ms": _mesh_time_ms(torch, lambda: app.inv(A), reps=1)}
    del A, cols
    out["warm"] = warm
    out["steps"] = info
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_mesh_core(torch, smi, app, X, y):
    """Phase 18 in the full run, on phase 15's world-1 mesh and its X
    (``MC_WORLD1``); KMeans and the GBT also bit for bit the serial
    backend's fits on the same tensors."""
    from nums_tpu_torch.core import application_manager

    mesh_app = application_manager._instance
    serial = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE)
    application_manager.set_instance(mesh_app)
    out = _mesh_core_steps(torch, app, X, y, MC_WORLD1, emit, {},
                           serial=serial)
    out.update({"phase": "mesh_core", "world": 1, "shape": list(X.shape),
                "nvidia_smi": smi, "peak_bytes": max(
                    st["peak_bytes"] for st in out["steps"].values())})
    emit(out)
    return out


def _mesh_core_cards(torch, cfg):
    """--mesh-core-only on this rank: X of 10M x 1000 fp32 drawn on the
    (cards, 1) mesh from phase 4's seed and its planted labels, then
    ``_mesh_core_steps``; each card's peak below X's bytes; rank 0 prints
    the phase's line."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager

    world = dist.get_world_size()
    n, d = cfg["n"], cfg["d"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if dist.get_rank() == 0 else (
        lambda obj: print(json.dumps(obj)))
    head = {"world": world, "shape": [n, d], "cluster_shape": [world, 1]}
    X, draw_secs = _mesh_seconds(torch, lambda: _draw_mesh_x(
        torch, app, n, d))
    y, _ = planted_labels(torch, app, X)
    out = _mesh_core_steps(torch, app, X, y, {**MC_FULL, "n": n}, say, head)
    peaks = [None] * world
    dist.all_gather_object(peaks, max(
        [_mesh_peak(torch)] + [st["peak_bytes"] for st in
                               out["steps"].values()]))
    launches = [None] * world
    dist.all_gather_object(launches, {
        k: sum(s["launches"].get(k, 0) for s in out["steps"].values())
        for k in ("gram", "gram_weighted", "newton_stage",
                  "newton_stats")})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "mesh_core", **head, "draw_seconds": draw_secs, **out,
         "peak_bytes_per_card": peaks, "launches_per_card": launches,
         "nvidia_smi_per_card": smi})
    assert max(peaks) < 4.0 * n * d or DEVICE != "cuda", (
        peaks, "a card held X's bytes")


def phase_mesh_core_cards(torch, smi):
    """--mesh-core-only: one process per visible card, as --masks-only
    spawns them, each running ``_mesh_core_cards``; fails unless every
    rank exits 0 before ``MC_DEADLINE_S``. Returns the number of ranks."""
    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    cfg = {"n": MESH_N, "d": D_FULL, "device": DEVICE,
           "deadline": MC_DEADLINE_S, "out_dir": out_dir, "root": root,
           "entry": "_mesh_core_cards"}
    emit({"phase": "mesh_core_start", "world": world, "nvidia_smi": smi,
          "shape": [cfg["n"], cfg["d"]]})
    t0 = time.perf_counter()
    codes = _spawn_ranks(world, cfg)
    assert codes == [0] * world, ("mesh_core ranks' exit codes", codes)
    emit({"phase": "mesh_core_done", "world": world, "exit_codes": codes,
          "seconds": time.perf_counter() - t0})
    return world


# -- Phase 19: the mesh's slicing, shape and order ops (shape) ------------
# With --shape-only on every card at phase 15's 10M x 1000 and a vector of
# 2.5e9 (SHAPE_FULL); in the full run on phase 15's world-1 mesh at a
# smaller depth (SHAPE_WORLD1), bit for bit the serial backend's.
SHAPE_FULL = {"n": MESH_N, "vec": 2_500_000_000}
SHAPE_WORLD1 = {"n": 200_000, "vec": 10_000_000}
SHAPE_ROLL = 1_234_567
SHAPE_REL = 1e-5             # float32 stencils, FFT, polyval vs float64
# cov: the plain fp32 product of each card's 2.5M rows, as the serial cov
# takes it; 9.58e-5 on four cards and 5.1e-6 at world 1 (200k rows)
# measured, the limit about 3x the four-card reading
SHAPE_COV_REL = 3e-4
SHAPE_SLACK_BYTES = 64 << 20  # counts, splitters and halos beside a slab
SHAPE_HASH_P = 2147483647    # the position weights of the exact hash
SHAPE_DEADLINE_S = 900.0     # every rank exits 0 within, or the run fails
SHAPE_POLY = np.array([1.5, -2.0, 0.5])


# The checks of phase 19 that failed (each a check's own message): every
# rank reaches the same verdicts (each is read after a collective), so
# the phase runs on past one and fails at its end listing them all.
SHAPE_FAILED = []


def _shape_hold(ok, what):
    if not ok:
        SHAPE_FAILED.append(repr(what))


def _sh_box(app, a):
    """(this rank's box, its part) of a BlockArray on the mesh."""
    t = a.raw
    return app.backend.region(tuple(t.shape), t.placements), _local(a)


def _sh_sum(torch, value, dtype=None):
    """The sum over every rank of a tensor (int64 sums wrap alike on every
    rank: an exact hash), on this rank's device."""
    import torch.distributed as dist

    t = value.reshape(-1).to(_mesh_device(torch)).clone()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(t)
    return t


def _sh_hash(torch, local, flat0, ncols, chunk_elements=1 << 26):
    """Σ bits(x) · ((p · 1000003) mod P) over the rows of ``local`` (a 2-D
    part, or 1-D), p the flat position ``flat0 + row · ncols + col`` in
    the array it is read as: int64, wrapping alike on every rank. An
    exact hash of the values at their places (bits, not values)."""
    x = local.reshape(local.shape[0], -1) if local.ndim > 1 else \
        local.reshape(-1, 1)
    dev = x.device
    width = int(x.shape[1])
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        x.element_size()]
    total = torch.zeros((), dtype=torch.int64, device=dev)
    cols = torch.arange(width, device=dev, dtype=torch.int64)
    chunk = max(1, chunk_elements // width)
    for i in range(0, int(x.shape[0]), chunk):
        rows = torch.arange(i, min(i + chunk, int(x.shape[0])), device=dev,
                            dtype=torch.int64)
        p = flat0 + rows[:, None] * int(ncols) + cols[None, :]
        w = (p * 1000003) % SHAPE_HASH_P
        bits = x[i:i + chunk].contiguous().view(ints).to(torch.int64)
        total += (bits * w).sum()
    return total


def _sh_result_hash(torch, app, a):
    """``_sh_hash`` of a BlockArray result over this rank's box, where the
    box counts (a replicated part once)."""
    box, loc = _sh_box(app, a)
    if not app.backend.counts_here(a.raw.placements):
        return torch.zeros((), dtype=torch.int64, device=loc.device)
    ncols = int(np.prod(a.shape[1:], dtype=np.int64))
    return _sh_hash(torch, loc, box[0][0] * ncols if box else 0, ncols)


def _sh_moved(torch, app, a, src_hash, what):
    """The hash of a move's result equals the hash of the rows each rank
    sent to their places (summed over the ranks): bit for bit."""
    got = _sh_sum(torch, _sh_result_hash(torch, app, a))
    want = _sh_sum(torch, src_hash)
    _shape_hold(torch.equal(got, want), (what, int(got), int(want)))


def _sh_rows_hash(torch, xl, r0, d, dest_row, keep=None):
    """``_sh_hash`` of X's local rows (starting at global row ``r0``) at
    the flat places of a result whose row of X row i is ``dest_row(i)`` (an
    int64 tensor of rows, -1 for none), in a result of ``d`` columns."""
    rows = torch.arange(r0, r0 + xl.shape[0], device=xl.device,
                        dtype=torch.int64)
    dst = dest_row(rows)
    sel = dst >= 0 if keep is None else keep(rows)
    total = torch.zeros((), dtype=torch.int64, device=xl.device)
    idx = torch.nonzero(sel)[:, 0]
    for i in range(0, int(idx.shape[0]), 1 << 16):
        j = idx[i:i + (1 << 16)]
        total += _sh_hash_at(torch, xl[j], dst[j] * d)
    return total


def _sh_hash_at(torch, rows, flat0s):
    """``_sh_hash`` of rows at their own flat starts (one per row)."""
    ints = {4: torch.int32, 8: torch.int64}[rows.element_size()]
    width = int(rows.shape[1])
    p = flat0s[:, None] + torch.arange(width, device=rows.device,
                                       dtype=torch.int64)[None, :]
    w = (p * 1000003) % SHAPE_HASH_P
    return (rows.contiguous().view(ints).to(torch.int64) * w).sum()


def _sh_keys(torch, x):
    from nums_tpu_torch.core.ops import masking

    return masking.total_order_key(x)


def _sh_sorted_1d(torch, app, s, what, pos=None):
    """A sorted 1-D result (a BlockArray, or this rank's part of one): each
    rank's part non-decreasing (jnp's order), and each rank's last key at
    most the next non-empty rank's first; with ``pos`` (the parts'
    positions in the operand), equal keys in increasing positions (a
    stable sort)."""
    import torch.distributed as dist

    loc = _local(s) if hasattr(s, "raw") else s
    k = _sh_keys(torch, loc).to(torch.int64)
    ok = bool((k[1:] >= k[:-1]).all()) if k.numel() > 1 else True
    if pos is not None and k.numel() > 1:
        pos = pos.to(torch.int64)
        ok = ok and bool(((k[1:] != k[:-1]) | (pos[1:] > pos[:-1])).all())
    edge = (lambda t, i: int(t[i]) if t.numel() else 0)
    p = pos if pos is not None else k
    ends = torch.tensor([k.numel(), edge(k, 0), edge(p, 0), edge(k, -1),
                         edge(p, -1)], dtype=torch.int64,
                        device=_mesh_device(torch))
    every = [torch.empty_like(ends) for _ in range(dist.get_world_size())]
    dist.all_gather(every, ends)
    last = None
    for e in every:
        if int(e[0]):
            if last is not None:
                ok = ok and (last[0] < int(e[1]) or (
                    last[0] == int(e[1]) and (pos is None or last[1]
                                              < int(e[2]))))
            last = (int(e[3]), int(e[4]))
    _shape_hold(_all_true(torch, ok), (what, "not in order"))


def _sh_moments(torch, x, dim=None, chunk_elements=1 << 26):
    """Σ key and Σ key² of a float part (int64, wrapping): a permutation
    keeps both (per column with ``dim=0``); a chunk of rows at a time."""
    if dim is None:
        x = x.reshape(-1, 1)
    width = max(int(x.shape[1]), 1)
    acc = torch.zeros((2, width), dtype=torch.int64, device=x.device)
    step = max(1, chunk_elements // width)
    for i in range(0, int(x.shape[0]), step):
        k = _sh_keys(torch, x[i:i + step]).to(torch.int64)
        acc[0] += k.sum(dim=0)
        acc[1] += (k * k).sum(dim=0)
    return acc.sum(dim=1) if dim is None else acc.reshape(-1)


def _sh_permutation(torch, app, pos, n, what):
    """Positions that are a permutation of [0, n): each in range, and
    Σ p and Σ p² (int64, mod 2^64) those of [0, n)."""
    loc = _local(pos).to(torch.int64)
    ok = bool(((loc >= 0) & (loc < n)).all()) if loc.numel() else True
    got = _sh_sum(torch, torch.stack([loc.sum(), (loc * loc).sum()]))
    m = 1 << 64
    s1, s2 = n * (n - 1) // 2 % m, (n - 1) * n * (2 * n - 1) // 6 % m
    want = [s1 - m if s1 >= m // 2 else s1, s2 - m if s2 >= m // 2 else s2]
    _shape_hold(_all_true(torch, ok) and [int(v) for v in got] == want, (
        what, "not a permutation"))


def _sh_take(torch, app, v, pos):
    """v at this rank's positions (``mesh_ops.take``: one pull)."""
    from nums_tpu_torch.core.ops import mesh_ops

    return mesh_ops.take(app.backend, v.raw, _local(pos).to(torch.int64))


def _sh_rank_values(torch, app, v, ranks):
    """The values of the given ranks of v's elements (jnp's order) by
    ``mesh_ops.select_ranks`` on the float64 values (exact), over the
    mesh: no value leaves its rank."""
    from nums_tpu_torch.core.ops import mesh_ops

    loc = _local(v).double()
    dims = list(range(len(app.backend.device_grid.mesh_shape)))
    r = torch.tensor(ranks, dtype=torch.int64, device=loc.device)
    return mesh_ops.select_ranks(app.backend, loc, r, dims).float()


def _sh_global_at(torch, app, a, i):
    """Element i of a 1-D BlockArray on every rank (its holder's, one
    all-reduce)."""
    box, loc = _sh_box(app, a)
    val = torch.zeros((1,), dtype=torch.float64, device=loc.device)
    a0, a1 = box[0]
    if a0 <= i < a1 and app.backend.counts_here(a.raw.placements):
        val[0] = loc[i - a0].double()
    return float(_sh_sum(torch, val)[0])


def _sh_edges(torch, xl, r0, w):
    """Every rank's (first row, its first ``w`` rows, last ``w`` rows) of
    X, in float64 (one all-gather)."""
    import torch.distributed as dist

    d = xl.shape[1]
    buf = torch.zeros((2 * w, d), dtype=torch.float64, device=xl.device)
    m = int(xl.shape[0])
    buf[:min(w, m)] = xl[:w].double()
    buf[w:w + min(w, m)] = xl[max(0, m - w):].double()
    head = torch.tensor([r0, m], dtype=torch.int64, device=xl.device)
    heads = [torch.empty_like(head) for _ in range(dist.get_world_size())]
    bufs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(heads, head)
    dist.all_gather(bufs, buf)
    rows = {}
    for h, b in zip(heads, bufs):
        s, c = int(h[0]), int(h[1])
        for j in range(min(w, c)):
            rows[s + j] = b[j]
            rows[s + c - min(w, c) + j] = b[w + j]
    return rows


def _sh_row64(xl, r0, edges, i):
    if r0 <= i < r0 + xl.shape[0]:
        return xl[i - r0].double()
    return edges[i]


def _sh_check_rows(torch, app, res, xl, r0, n, ref_row, what):
    """A row-sharded float32 result held to float64 (``ref_row(i)``) on
    this rank's first, last and middle rows and the rows beside its box
    edges, within ``SHAPE_REL`` of max|ref|."""
    box, loc = _sh_box(app, res)
    a, b = box[0]
    worst = 0.0
    for i in sorted({a, a + 1, (a + b) // 2, b - 2, b - 1}):
        if a <= i < b:
            ref = ref_row(i)
            scale = max(float(ref.abs().max()), 1e-30)
            worst = max(worst, float((loc[i - a].double() - ref).abs().max())
                        / scale)
    worst = _all_max(torch, worst)
    _shape_hold(worst <= SHAPE_REL, (what, worst))
    return worst


def _shape_steps(torch, app, X, v, k, cfg, step, out, checks=True,
                 keep=True):
    """Every step of phase 19 on this rank (the mesh of X's app): each
    result held to its check where ``checks`` (every rank joins each
    check's collectives); returns name -> result (with ``keep``, every
    one, for the world-1 comparison with the serial backend; else each
    goes once checked, for memory)."""
    import nums_tpu_torch.numpy as nps

    if isinstance(X, list):
        X = X.pop()  # the only reference: X goes before the vector steps
    n, d = (int(s) for s in X.shape)
    nv = int(v.shape[0])
    mesh = app.backend.mesh is not None
    drop = not keep
    res = {}
    xbox, xl = _sh_box(app, X) if mesh else (((0, n), (0, d)), X.raw)
    r0, r1 = xbox[0]

    def rows_hash(dest_row, width=d, part=None):
        return _sh_rows_hash(torch, xl if part is None else part, r0, width,
                             dest_row)

    def done(*names):
        """Each result goes once checked (for memory) unless kept."""
        if drop:
            for name in names:
                del res[name]
            _mesh_free(torch)

    def moved(name, fn, dest_row, width=d, part=None):
        res[name] = step(name, fn)
        if checks:
            _sh_moved(torch, app, res[name], rows_hash(dest_row, width, part),
                      name)
        done(name)

    one, mid, three = n // 10, n // 2, 9 * n // 10
    moved("slice", lambda: X[one:three],
          lambda i: torch.where((i >= one) & (i < three), i - one, -1))
    moved("step2", lambda: X[::2],
          lambda i: torch.where(i % 2 == 0, i // 2, -1))
    moved("reverse", lambda: X[::-1], lambda i: n - 1 - i)
    res["row"] = step("row", lambda: X[mid])
    if checks:
        same = True
        if r0 <= mid < r1:
            same = bool(torch.equal(_local(res["row"]), xl[mid - r0]))
        _shape_hold(_all_true(torch, same), "row")
    done("row")
    q = n // 4
    moved("split", lambda: nps.split(X, 4)[2],
          lambda i: torch.where((i >= 2 * q) & (i < 3 * q), i - 2 * q, -1))
    moved("reshape", lambda: X.reshape(2 * n, d // 2), lambda i: i)
    moved("ravel", lambda: nps.ravel(X), lambda i: i)
    res["concatenate"] = step("concatenate", lambda: nps.concatenate([X, X]))
    if checks:
        _sh_moved(torch, app, res["concatenate"], rows_hash(lambda i: i)
                  + rows_hash(lambda i: i + n), "concatenate")
    done("concatenate")
    moved("flip", lambda: nps.flip(X, 0), lambda i: n - 1 - i)
    moved("roll", lambda: nps.roll(X, SHAPE_ROLL, 0),
          lambda i: (i + SHAPE_ROLL) % n)
    edges = _sh_edges(torch, xl, r0, 2) if checks else {}

    def row64(i):
        return _sh_row64(xl, r0, edges, i)

    res["diff"] = step("diff", lambda: nps.diff(X, axis=0))
    if checks:
        out["diff_rel"] = _sh_check_rows(
            torch, app, res["diff"], xl, r0, n,
            lambda i: row64(i + 1) - row64(i), "diff")
    done("diff")
    res["gradient"] = step("gradient", lambda: nps.gradient(X, axis=0))
    if checks:
        out["gradient_rel"] = _sh_check_rows(
            torch, app, res["gradient"], xl, r0, n,
            lambda i: (row64(1) - row64(0) if i == 0 else
                       row64(n - 1) - row64(n - 2) if i == n - 1 else
                       (row64(i + 1) - row64(i - 1)) * 0.5), "gradient")
    done("gradient")
    res["tril"] = step("tril", lambda: nps.tril(X))
    if checks:
        tbox, tl = _sh_box(app, res["tril"])
        _shape_hold(_all_true(torch, bool(torch.equal(tl, torch.tril(
            xl, diagonal=tbox[0][0] - tbox[1][0])))), "tril")
        del tl
    done("tril")
    cols = X[:, :64]
    res["rfft"] = step("rfft", lambda: nps.fft.rfft(cols, axis=0))
    if checks:
        out["rfft_rel"] = _sh_rfft_check(torch, app, res["rfft"], xl[:, :64],
                                         r0, n)
    done("rfft")
    res["cov"] = step("cov", lambda: nps.cov(X, rowvar=False))
    if checks:
        out["cov_rel"] = _sh_cov_check(torch, app, res["cov"], xl, n)
    done("cov")
    res["sort_rows"] = step("sort_rows", lambda: nps.sort(X, axis=0))
    if checks:
        _sh_sorted_rows(torch, app, res["sort_rows"], xl)
    done("sort_rows")
    head, eight = X[:, :250], X[:, :8]
    el = _local(eight) if mesh else eight.raw
    if drop:
        del X, xl, cols
        _mesh_free(torch)
    res["sort_flat"] = step("sort_flat", lambda: nps.sort(head, axis=None))
    if checks:
        _sh_sorted_1d(torch, app, res["sort_flat"], "sort_flat")
        _shape_hold(torch.equal(
            _sh_sum(torch, _sh_moments(torch, _local(res["sort_flat"]))),
            _sh_sum(torch, _sh_moments(torch, _local(head)))), "sort_flat")
    done("sort_flat")
    res["kron"] = step("kron", lambda: nps.kron(eight, np.ones((2, 1))))
    if checks:
        _sh_moved(torch, app, res["kron"], _sh_rows_hash(
            torch, el, r0, 8, lambda i: 2 * i) + _sh_rows_hash(
                torch, el, r0, 8, lambda i: 2 * i + 1), "kron")
    done("kron")
    res["resize"] = step("resize", lambda: nps.resize(eight, (2 * n, 8)))
    if checks:
        _sh_moved(torch, app, res["resize"], _sh_rows_hash(
            torch, el, r0, 8, lambda i: i) + _sh_rows_hash(
                torch, el, r0, 8, lambda i: i + n), "resize")
    done("resize")
    if drop:
        del head, eight, el
    # the vector steps (phase 19's X is no longer read)
    vl = _local(v)
    res["sort"] = step("sort", lambda: nps.sort(v))
    if checks:
        _sh_sorted_1d(torch, app, res["sort"], "sort")
        ranks = [0, nv // 4, nv // 2, nv - 1]
        sel = _sh_rank_values(torch, app, v, ranks)
        got = [_sh_global_at(torch, app, res["sort"], r) for r in ranks]
        _shape_hold([float(s) for s in sel] == got, ("sort ranks", got))
        _shape_hold(torch.equal(_sh_sum(torch, _sh_moments(torch, _local(
            res["sort"]))), _sh_sum(torch, _sh_moments(torch, vl))), "sort")
    done("sort")
    res["argsort"] = step("argsort", lambda: nps.argsort(v))
    if checks:
        # a permutation at which v is in order, ties by position: the one
        # stable sort (the sorted values' own check is the step before)
        _sh_permutation(torch, app, res["argsort"], nv, "argsort")
        taken = _sh_take(torch, app, v, res["argsort"])
        _sh_sorted_1d(torch, app, taken, "argsort: v at the positions",
                      pos=_local(res["argsort"]))
        del taken
    done("argsort")
    kth = nv // 2
    res["partition"] = step("partition", lambda: nps.partition(v, kth))
    if checks:
        _sh_selection(torch, app, v, _local(res["partition"]),
                      _sh_box(app, res["partition"])[0][0][0], kth,
                      "partition")
        _shape_hold(torch.equal(_sh_sum(torch, _sh_moments(
            torch, _local(res["partition"]))), _sh_sum(
                torch, _sh_moments(torch, vl))), "partition")
    done("partition")
    kq = nv // 4
    res["argpartition"] = step("argpartition",
                               lambda: nps.argpartition(v, kq))
    if checks:
        _sh_permutation(torch, app, res["argpartition"], nv, "argpartition")
        taken = _sh_take(torch, app, v, res["argpartition"])
        _sh_selection(torch, app, v, taken, _sh_box(
            app, res["argpartition"])[0][0][0], kq, "argpartition")
        del taken
    done("argpartition")
    res["lexsort"] = step("lexsort", lambda: nps.lexsort((k, v)))
    if checks:
        _sh_permutation(torch, app, res["lexsort"], nv, "lexsort")
        _sh_lex_check(torch, app, v, k, res["lexsort"])
    done("lexsort")
    res["vander"] = step("vander", lambda: nps.vander(v, 3))
    if checks:
        from nums_tpu_torch.core.ops import elementwise

        iota = torch.tensor([2.0, 1.0, 0.0], dtype=vl.dtype,
                            device=vl.device)
        want = elementwise.bop("power", vl[:, None], iota[None, :],
                               vl.dtype)
        _shape_hold(_all_true(torch, bool(torch.equal(_local(res["vander"]),
                                                 want))), "vander")
        del want
    done("vander")
    p = app.array(SHAPE_POLY.astype(np.float32), block_shape=(3,))
    res["polyval"] = step("polyval", lambda: nps.polyval(p, v))
    if checks:
        x64 = vl[:1 << 20].double()
        ref = (1.5 * x64 - 2.0) * x64 + 0.5
        err = float((_local(res["polyval"])[:1 << 20].double() - ref).abs()
                    .max()) / max(float(ref.abs().max()), 1e-30) \
            if x64.numel() else 0.0
        out["polyval_rel"] = _all_max(torch, err)
        _shape_hold(out["polyval_rel"] <= SHAPE_REL, out["polyval_rel"])
    return res


def _sh_selection(torch, app, v, part, start, kth, what):
    """A partition's values (this rank's ``part`` at positions from
    ``start``): the kth is v's kth smallest (``select_ranks``, bit for
    bit), none before it above it, none after it below it (jnp's order)."""
    piv = _sh_rank_values(torch, app, v, [kth])[0].to(part.dtype)
    pk = int(_sh_keys(torch, piv.reshape(1))[0])
    keys = _sh_keys(torch, part).to(torch.int64)
    pos = torch.arange(start, start + part.shape[0], device=part.device)
    ok = bool((keys[pos < kth] <= pk).all()) and bool(
        (keys[pos > kth] >= pk).all())
    at = pos == kth
    if bool(at.any()):
        ok = ok and int(keys[at][0]) == pk
    _shape_hold(_all_true(torch, ok), (what, "not a partition at kth"))


def _sh_lex_check(torch, app, v, k, pos):
    """v and k at lexsort's positions: (v, k) non-decreasing within each
    rank's part and across the ranks' boundaries."""
    import torch.distributed as dist

    vk = _sh_keys(torch, _sh_take(torch, app, v, pos)).to(torch.int64)
    kk = _sh_take(torch, app, k, pos).to(torch.int64)
    ok = True
    if vk.numel() > 1:
        up = vk[1:] > vk[:-1]
        same = vk[1:] == vk[:-1]
        ok = bool((up | (same & (kk[1:] >= kk[:-1]))).all())
    ends = torch.tensor([vk.numel(), int(vk[0]) if vk.numel() else 0,
                         int(kk[0]) if vk.numel() else 0,
                         int(vk[-1]) if vk.numel() else 0,
                         int(kk[-1]) if vk.numel() else 0],
                        dtype=torch.int64, device=_mesh_device(torch))
    every = [torch.empty_like(ends) for _ in range(dist.get_world_size())]
    dist.all_gather(every, ends)
    last = None
    for e in every:
        if int(e[0]):
            if last is not None:
                ok = ok and last <= (int(e[1]), int(e[2]))
            last = (int(e[3]), int(e[4]))
    _shape_hold(_all_true(torch, ok), "lexsort: not in order")


def _sh_sorted_rows(torch, app, s, xl):
    """sort(X, axis=0): each column of each rank's rows non-decreasing,
    each rank's last row at most the next non-empty rank's first, and each
    column's key moments X's."""
    import torch.distributed as dist

    loc = _local(s)
    k = _sh_keys(torch, loc)
    ok = bool((k[1:] >= k[:-1]).all()) if k.shape[0] > 1 else True
    d = loc.shape[1]
    ends = torch.zeros((2, d), dtype=torch.int64, device=loc.device)
    if k.shape[0]:
        ends[0], ends[1] = k[0], k[-1]
    cnt = torch.tensor([k.shape[0]], dtype=torch.int64, device=loc.device)
    every = [torch.empty_like(ends) for _ in range(dist.get_world_size())]
    counts = [torch.empty_like(cnt) for _ in range(dist.get_world_size())]
    dist.all_gather(every, ends)
    dist.all_gather(counts, cnt)
    last = None
    for e, c in zip(every, counts):
        if int(c[0]):
            if last is not None:
                ok = ok and bool((last <= e[0]).all())
            last = e[1]
    _shape_hold(_all_true(torch, ok), "sort_rows: not in order")
    _shape_hold(torch.equal(_sh_sum(torch, _sh_moments(torch, loc, 0)),
                            _sh_sum(torch, _sh_moments(torch, xl, 0))),
                "sort_rows: not a permutation of each column")


def _sh_rfft_check(torch, app, res, cl, r0, n):
    """rfft(X[:, :64], axis=0) at frequencies 0, 1 and n/4 against float64
    sums of each rank's rows (one all-reduce), within ``SHAPE_REL``."""
    worst = 0.0
    rows = torch.arange(r0, r0 + cl.shape[0], device=cl.device,
                        dtype=torch.float64)
    box, loc = _sh_box(app, res)
    a, b = box[0]
    for f in (0, 1, n // 4):
        ang = -2.0 * np.pi * ((rows * f) % n) / n
        w = torch.polar(torch.ones_like(ang), ang)
        part = (cl.double() * w[:, None]).sum(dim=0) if cl.shape[0] else \
            torch.zeros(cl.shape[1], dtype=torch.complex128,
                        device=cl.device)
        ref = _sh_sum(torch, part)
        err = 0.0
        if a <= f < b:
            err = float((loc[f - a].to(torch.complex128) - ref).abs().max()) \
                / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, _all_max(torch, err))
    _shape_hold(worst <= SHAPE_REL, ("rfft", worst))
    return worst


def _sh_cov_check(torch, app, res, xl, n):
    """cov(X, rowvar=False) against the float64 centred gram of each
    rank's rows (one all-reduce of the sums, one of the gram)."""
    sums = torch.zeros(xl.shape[1], dtype=torch.float64, device=xl.device)
    for i in range(0, xl.shape[0], MESH_CHUNK):
        sums += xl[i:i + MESH_CHUNK].double().sum(dim=0)
    mean = _sh_sum(torch, sums) / n
    g = torch.zeros((xl.shape[1], xl.shape[1]), dtype=torch.float64,
                    device=xl.device)
    for i in range(0, xl.shape[0], MESH_CHUNK):
        c = xl[i:i + MESH_CHUNK].double() - mean
        g += c.T @ c
    ref = _sh_sum(torch, g).reshape(g.shape) / (n - 1)
    got = _local(res).double()
    rel = _all_max(torch, float((got - ref).abs().max())
                   / float(ref.abs().max()))
    _shape_hold(rel <= SHAPE_COV_REL, ("cov", rel))
    return rel


def _shape_bounds(local_x, local_v, d, world):
    """The bytes a rank may send in each step, beside
    ``SHAPE_SLACK_BYTES`` for counts, splitters and halos: the slabs it
    moves (its rows of X, of a slice of them). The sample sorts of v (m
    elements a rank) by their payloads, per element and per round:
    * the all-to-all to the rank of each key range carries the 4 B value,
      the 8 B position where positions are asked, and lexsort's 4 B of k;
      v is drawn i.i.d. and the splitters cut it in even ranges, so a
      rank keeps 1/world of its elements and sends the rest;
    * the round that lays the sorted runs out carries the result, a 4 B
      value or an 8 B position, at most for each element of the run;
    * argpartition sends its chosen positions (8 B each, at most the run)
      to their holders once more.
    So sort and partition 4·off + 4, argsort 12·off + 8, argpartition
    12·off + 16, lexsort 16·off + 8 bytes an element, off =
    (world - 1) / world."""
    x, m = local_x, local_v // 4
    off = (world - 1) / world

    def sample(payload, placed):
        return int(off * payload * m) + placed * m

    return {"slice": x, "step2": x, "reverse": x, "row": 0, "split": x,
            "reshape": x, "ravel": x, "concatenate": 2 * x, "flip": x,
            "roll": x, "diff": 0, "gradient": 0, "tril": 0,
            "rfft": 4 * x * 64 // d, "cov": 0, "sort_rows": 2 * x,
            "sort_flat": 2 * x // 4, "kron": 4 * x * 8 // d,
            "resize": 4 * x * 8 // d, "sort": sample(4, 4),
            "argsort": sample(12, 8), "partition": sample(4, 4),
            "argpartition": sample(12, 16), "lexsort": sample(16, 8),
            "vander": 0, "polyval": 0}


def _shape_step_fn(torch, info):
    """The ``step`` of ``_shape_steps``: each step run once cold (its
    seconds kept as ``cold_seconds``, its result dropped), then again
    warm: its seconds (host clock after a barrier, the slowest rank's),
    the bytes this rank sent through the port's collectives (and by
    all-to-all alone), the collectives ``CommDebugMode`` saw (DTensor's own
    inside a torch op too), the kernel launches (set to 0 just before it,
    read just after) and the peak."""
    from torch.distributed.tensor.debug import CommDebugMode

    from nums_tpu_torch.core import multiprocess

    def step(name, fn):
        cold = _mesh_seconds(torch, fn)[1]
        _mesh_free(torch)
        sent = multiprocess.SENT["bytes"]
        moved = multiprocess.EXCHANGED["bytes_sent"]
        _reset_counts()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mode = CommDebugMode()
        with mode:
            res, secs = _mesh_seconds(torch, fn)
        info[name] = {"seconds": secs, "cold_seconds": cold,
                      "bytes_sent": multiprocess.SENT["bytes"] - sent,
                      "all_to_all_bytes_sent":
                      multiprocess.EXCHANGED["bytes_sent"] - moved,
                      "collectives": {str(k).split(".")[-1]: v for k, v in
                                      mode.get_comm_counts().items() if v},
                      "launches": {k: v for k, v in _counts().items() if v},
                      "peak_bytes": _mesh_peak(torch)}
        return res

    return step


def _shape_held(torch, info, bounds, x_bytes):
    """Every step: no all-gather inside a torch op (DTensor's own), no
    kernel launched, its bytes within its bound, its peak below X's
    bytes (on the cards of a mesh of several; ``x_bytes`` None on one,
    which holds X whole); a failure goes to ``SHAPE_FAILED``."""
    for name, st in info.items():
        _shape_hold("all_gather_into_tensor" not in st["collectives"], (
            name, st["collectives"]))
        _shape_hold(not st["launches"], (name, st["launches"]))
        _shape_hold(st["bytes_sent"] <= bounds[name] + SHAPE_SLACK_BYTES, (
            name, st["bytes_sent"], bounds[name]))
        _shape_hold(DEVICE != "cuda" or x_bytes is None
                    or st["peak_bytes"] < x_bytes, (name, st["peak_bytes"]))


def _shape_vectors(torch, app, nv):
    """v (nv float32 normals) and k (nv int32 integers in [0, 1000)),
    drawn sharded over the whole mesh."""
    blocks = -(-nv // app.backend.num_devices)
    rs = app.random_state(LA_SEED + 19)
    v = rs.normal(shape=(nv,), block_shape=(blocks,), dtype=np.float32)
    k = rs.integers(0, 1000, shape=(nv,), block_shape=(blocks,),
                    dtype=np.int32)
    return v, k


def phase_shape(torch, smi, app, X):
    """Phase 19 in the full run, on phase 15's world-1 mesh: X's first
    ``SHAPE_WORLD1["n"]`` rows and a vector of ``SHAPE_WORLD1["vec"]``,
    every step on the mesh and again on the serial backend with the same
    tensors, every result bit for bit equal and held to its check; no
    kernel launched."""
    from nums_tpu_torch.core import application_manager

    t_phase = time.perf_counter()
    n = SHAPE_WORLD1["n"]
    mesh_app = application_manager._instance
    Xs = X[:n]
    v, k = _shape_vectors(torch, app, SHAPE_WORLD1["vec"])
    info, out = {}, {}
    got = _shape_steps(torch, app, Xs, v, k, SHAPE_WORLD1,
                       _shape_step_fn(torch, info), out)
    serial = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE)
    application_manager.set_instance(serial)
    try:
        twins = [_serial_twin(serial.backend, a) for a in (Xs, v, k)]
        ref = _shape_steps(torch, serial, *twins, SHAPE_WORLD1,
                           lambda name, fn: fn(), {}, checks=False)
    finally:
        application_manager.set_instance(mesh_app)
    differ = _same_results(torch, got, ref)
    _shape_hold(not differ, ("mesh vs serial", differ))
    bounds = _shape_bounds(4 * n * D_FULL, 4 * SHAPE_WORLD1["vec"], D_FULL,
                           1)
    _shape_held(torch, info, bounds, None)
    launches = {name: 0 for name, _, _ in KERNELS}
    out.update({"phase": "shape", "world": 1, "shape": [n, D_FULL],
                "vector": SHAPE_WORLD1["vec"], "nvidia_smi": smi,
                "steps": info, "launches": launches,
                "bitwise_vs_serial": sorted(got), "failed": SHAPE_FAILED,
                "seconds": time.perf_counter() - t_phase})
    del got, ref, twins, Xs, v, k
    _mesh_free(torch)
    emit(out)
    assert not SHAPE_FAILED, SHAPE_FAILED
    return out


def _shape_cards(torch, cfg):
    """--shape-only on this rank: X of 10M x 1000 fp32 drawn on the
    (cards, 1) mesh from phase 4's seed, v and k of 2.5e9 drawn sharded,
    then ``_shape_steps`` with every check; each step held to its bytes,
    no all-gather inside a torch op, no kernel, its peak below X's bytes;
    rank 0 prints the phase's line."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager

    world = dist.get_world_size()
    n, d, nv = cfg["n"], cfg["d"], cfg["vec"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if dist.get_rank() == 0 else (
        lambda obj: print(json.dumps(obj)))
    head = {"world": world, "shape": [n, d], "vector": nv,
            "cluster_shape": [world, 1]}
    t0 = time.perf_counter()
    X, draw_secs = _mesh_seconds(torch, lambda: _draw_mesh_x(torch, app, n,
                                                             d))
    (v, k), vec_secs = _mesh_seconds(torch, lambda: _shape_vectors(
        torch, app, nv))
    info, out = {}, {}
    bounds = _shape_bounds(_local(X).numel() * 4, _local(v).numel() * 4, d,
                           world)
    held = [X]
    del X
    _shape_steps(torch, app, held, v, k, cfg, _shape_step_fn(torch, info),
                 out, keep=False)
    _shape_held(torch, info, bounds, 4 * n * d)
    peaks = [None] * world
    dist.all_gather_object(peaks, max(st["peak_bytes"]
                                      for st in info.values()))
    launches = [None] * world
    dist.all_gather_object(launches, {
        name: sum(st["launches"].get(name, 0) for st in info.values())
        for name, _, _ in KERNELS})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "shape", **head, "draw_seconds": draw_secs,
         "vector_draw_seconds": vec_secs, **out, "steps": info,
         "bounds": bounds, "peak_bytes_per_card": peaks,
         "launches_per_card": launches, "nvidia_smi_per_card": smi,
         "failed": SHAPE_FAILED, "seconds": time.perf_counter() - t0})
    assert all(sum(c.values()) == 0 for c in launches), launches
    assert not SHAPE_FAILED, SHAPE_FAILED


def phase_shape_cards(torch, smi):
    """--shape-only: one process per visible card, as --mesh-core-only
    spawns them, each running ``_shape_cards``; fails unless every rank
    exits 0 before ``SHAPE_DEADLINE_S``. Returns the number of ranks."""
    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    cfg = {"n": SHAPE_FULL["n"], "d": D_FULL, "vec": SHAPE_FULL["vec"],
           "device": DEVICE, "deadline": SHAPE_DEADLINE_S,
           "out_dir": out_dir, "root": root, "entry": "_shape_cards"}
    emit({"phase": "shape_start", "world": world, "nvidia_smi": smi,
          "shape": [cfg["n"], cfg["d"]], "vector": cfg["vec"]})
    t0 = time.perf_counter()
    codes = _spawn_ranks(world, cfg)
    assert codes == [0] * world, ("shape ranks' exit codes", codes)
    emit({"phase": "shape_done", "world": world, "exit_codes": codes,
          "seconds": time.perf_counter() - t0})
    return world


# -- Phase 20: the random layer on the mesh (mesh_random) -----------------
# With --mesh-random-only on every card at phase 15's 10M x 1000
# (MR_FULL); in the full run on phase 15's world-1 mesh at a smaller
# depth (MR_WORLD1), every result bit for bit the serial backend's.
MR_FULL = {"n": MESH_N, "narrow": 100, "perm": 2_500_000_000,
           "choice": 5_000_000, "mvn": 64, "la_rows": 100_000,
           "vec": 100_000, "rounds_check": (1_000_000, 100)}
MR_WORLD1 = {"n": 100_000, "narrow": 100, "perm": 5_000_000,
             "choice": 50_000, "mvn": 64, "la_rows": 5_000,
             "vec": 5_000, "rounds_check": (50_000, 100)}
MR_SEED = LA_SEED + 20
MR_DEADLINE_S = 900.0        # every rank exits 0 within, or the run fails
MR_SIGMAS = 6.0              # a sample moment within 6 standard errors
MR_KURTOSIS = 16.0           # bounds μ4/σ⁴ − 1 of the laws here: the
                             # sample variance's error is σ²·√(16/N) at most
MR_LA_REL = 1e-5             # fp32 products of 1000 terms vs float64
MR_PINV_REL = 1e-3           # ‖A·pinv(A)·A − A‖/‖A‖, ‖pinv(A)·A − I‖ (fp32)
MR_SAMPLE_ROWS = 64          # rows of a result a rank holds to float64
# (name, call on a random state, its law: mean, variance or None, the
# least and the largest value or None, integer values)
MR_LAWS = {
    "poisson_30": (lambda rs, s, b: rs.poisson(30.0, shape=s, block_shape=b,
                                               dtype=np.float32),
                   30.0, 30.0, 0, None, True),
    "poisson_3": (lambda rs, s, b: rs.poisson(3.0, shape=s, block_shape=b,
                                              dtype=np.float32),
                  3.0, 3.0, 0, None, True),
    "binomial": (lambda rs, s, b: rs.binomial(100, 0.3, shape=s,
                                              block_shape=b,
                                              dtype=np.float32),
                 30.0, 21.0, 0, 100, True),
    "negative_binomial": (lambda rs, s, b: rs.negative_binomial(
        5, 0.5, shape=s, block_shape=b, dtype=np.float32), 5.0, 10.0, 0,
        None, True),
    "noncentral_chisquare": (lambda rs, s, b: rs.noncentral_chisquare(
        0.5, 2.0, shape=s, block_shape=b, dtype=np.float32), 2.5, 9.0, 0,
        None, False),
    # (a variance, but no fourth moment: its mean alone, by its variance)
    "noncentral_f": (lambda rs, s, b: rs.noncentral_f(
        3, 5, 2.0, shape=s, block_shape=b, dtype=np.float32), 25.0 / 9.0,
        -2.0 * (5.0 / 3.0) ** 2 * (25.0 + 7.0 * 3.0) / 9.0, 0, None, False),
    "hypergeometric": (lambda rs, s, b: rs.hypergeometric(
        50, 50, 20, shape=s, block_shape=b, dtype=np.int32), 10.0,
        20 * 0.25 * 80 / 99, 0, 20, True),
}
# The mean's offset that the reference's algorithm itself has at float32,
# beside its standard errors (the float32 terms of BTRS's acceptance
# bound): jax's binomial(100, 0.3) at float32 (x64 off) draws a mean
# 1.5e-3 below 30 on the CPU, as the port's CPU route does
# (tests/measure_binomial_f32_bias.py, 2e8 draws each), and the port's
# draw on the card 1.6e-3 below over 1e10; 3e-3 is about twice that.
MR_F32_BIAS = {"binomial": 3e-3}
MR_FAILED = []


def _mr_hold(ok, what):
    if not ok:
        MR_FAILED.append(repr(what))


def _mr_var_tol(var, n):
    """``MR_SIGMAS`` standard errors of a sample variance of n draws."""
    return MR_SIGMAS * var * np.sqrt(MR_KURTOSIS / n)


def _mr_moments(torch, a):
    """(count, Σx, Σx², min, max) over every rank of a BlockArray's
    values, in float64, a chunk of rows at a time (a replicated part
    once)."""
    loc = _local(a).reshape(-1)
    here = a.backend.mesh is None or a.backend.counts_here(a.raw.placements)
    s = torch.zeros(5, dtype=torch.float64, device=_mesh_device(torch))
    s[3], s[4] = float("inf"), -float("inf")
    if here:
        for i in range(0, int(loc.numel()), 1 << 26):
            c = loc[i:i + (1 << 26)].to(torch.float64)
            s[0] += c.numel()
            s[1] += c.sum()
            s[2] += (c * c).sum()
            s[3] = torch.minimum(s[3], c.min())
            s[4] = torch.maximum(s[4], c.max())
    tot = _sh_sum(torch, s[:3])
    lo = _all_max(torch, -float(s[3]))
    hi = _all_max(torch, float(s[4]))
    n, s1, s2 = (float(v) for v in tot)
    return n, s1, s2, -lo, hi


def _mr_law(torch, a, name, mean, var, lo, hi, integer):
    """A draw held to its law: the sample mean and variance within
    ``MR_SIGMAS`` standard errors (a negative ``var``: the variance that
    bounds the mean, not held), the range, and integer values where the
    law's are. Returns the moments."""
    n, s1, s2, mn, mx = _mr_moments(torch, a)
    m = s1 / n
    v = s2 / n - m * m
    bias = MR_F32_BIAS.get(name, 0.0) if a.dtype == np.float32 else 0.0
    _mr_hold(abs(m - mean) <= MR_SIGMAS * np.sqrt(abs(var) / n) + bias,
             (name, "mean", m, mean))
    if var > 0:
        _mr_hold(abs(v - var) <= _mr_var_tol(var, n), (name, "variance", v,
                                                       var))
    _mr_hold(lo is None or mn >= lo, (name, "min", mn))
    _mr_hold(hi is None or mx <= hi, (name, "max", mx))
    if integer:
        loc = _local(a).reshape(-1)
        bad = 0
        for i in range(0, int(loc.numel()) if loc.is_floating_point()
                       else 0, 1 << 26):
            c = loc[i:i + (1 << 26)]
            bad += int((c != torch.floor(c)).sum())
        _mr_hold(_all_max(torch, float(bad)) == 0.0,
                 (name, "integer values"))
    return {"mean": m, "variance": v, "min": mn, "max": mx, "count": n}


def _mr_counts(torch, app, values, n):
    """The largest and the least count of a value of [0, n) among the
    int64 values (this rank's part of a sharded draw) over every rank:
    each value sent to the rank that owns its range (one all-to-all),
    counted there."""
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess

    world = dist.get_world_size()
    chunk = -(-n // world)
    v = values.reshape(-1)
    dest = torch.div(v, chunk, rounding_mode="floor")
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=world).cpu().numpy()
    recv = multiprocess.all_gather_ints(send)[:, dist.get_rank()]
    got = multiprocess.exchange(v[order], send, recv)
    del order, dest
    lo = dist.get_rank() * chunk
    width = max(0, min(n, lo + chunk) - lo)
    c = torch.bincount(got - lo, minlength=width)
    top = float(c.max()) if width else 0.0
    least = float(c.min()) if width else float("inf")
    return _all_max(torch, top), -_all_max(torch, -least)


def _mr_rows_check(torch, app, result, ind, X, what):
    """``MR_SAMPLE_ROWS`` rows of each rank's part of a choice of X's rows
    equal, bit for bit, X's rows at their drawn positions (``ind``, the
    same choice of X's row numbers), read by a host index array."""
    import torch.distributed as dist

    loc, idx = _local(result), _local(ind).reshape(-1)
    k = min(MR_SAMPLE_ROWS, int(loc.shape[0]))
    mine = (idx[:k].cpu().numpy(), loc[:k].cpu().numpy())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    rows = np.concatenate([e[0] for e in every])
    want = np.concatenate([e[1] for e in every])
    got = np.asarray(X[rows].get()) if rows.size else want
    _mr_hold(np.array_equal(got.view(np.uint8), want.view(np.uint8)),
             (what, "rows at the drawn positions"))


def _mr_sampled_rows(torch, app, R, Xs, ref_fn, what):
    """``MR_SAMPLE_ROWS`` rows of each rank's part of an (n, n) result
    held to ``ref_fn(rows of Xs, Xs)`` in float64 (Xs read whole to the
    host for the check alone), relative to max|ref|."""
    box, loc = _sh_box(app, R)
    xs = torch.from_numpy(np.asarray(Xs.get(), dtype=np.float64)).to(
        loc.device)
    k = min(MR_SAMPLE_ROWS, int(loc.shape[0]))
    rows = torch.arange(box[0][0], box[0][0] + k, device=loc.device)
    ref = ref_fn(xs[rows], xs)[:, box[1][0]:box[1][1]]
    got = loc[:k].to(torch.float64)
    rel = float((got - ref).abs().max() / ref.abs().max()) if k else 0.0
    rel = _all_max(torch, rel)
    _mr_hold(rel <= MR_LA_REL, (what, rel))
    return rel


def _mr_diag_check(torch, app, D, v, k, what):
    """The k-th diagonal of each rank's box of D equals v's elements there
    (an exact hash of bits at their places over the ranks, beside the
    hash of v) and nothing else in the box is nonzero."""
    box, loc = _sh_box(app, D)
    (a, b), (c, e) = box
    r0, c0 = max(0, -k), max(0, k)
    lo = max(a - r0, c - c0, 0)
    hi = max(lo, min(b - r0, e - c0, int(v.shape[0])))
    i = torch.arange(lo, hi, device=loc.device, dtype=torch.int64)
    diag = loc[i + r0 - a, i + c0 - c]
    got = _sh_sum(torch, _sh_hash_at(torch, diag.reshape(-1, 1), i))
    want = _sh_sum(torch, _sh_result_hash(torch, app, v))
    _mr_hold(torch.equal(got, want), (what, "diagonal", int(got),
                                      int(want)))
    extra = int(torch.count_nonzero(loc)) - int(torch.count_nonzero(diag))
    _mr_hold(_all_max(torch, float(extra)) == 0.0, (what, "off-diagonal"))


def _mr_steps(torch, app, X, cfg, step, out, checks=True, keep_all=False):
    """Every step of phase 20 on this rank (the mesh of X's app): each
    result held to its check where ``checks``; returns name -> result
    (each a BlockArray, every one with ``keep_all``, for the world-1
    comparison with the serial backend; else each goes once checked, for
    memory). ``X`` (or a function that draws it, called after the
    permutation: the samplers and the permutation run without X resident)
    is shuffled in place."""
    import torch.distributed as dist

    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core.ops import random_ops

    world = app.backend.num_devices if app.backend.mesh is not None else 1
    n, d = cfg["n"], cfg["d"]
    rows = -(-n // world)
    narrow = cfg["narrow"]
    res, laws, rounds = {}, {}, {}

    def keep(name, value):
        if keep_all:
            res[name] = value

    for name, (call, mean, var, lo, hi, integer) in MR_LAWS.items():
        shape = (n, d) if name in ("poisson_30", "poisson_3",
                                   "binomial") else (n, narrow)
        r = random_ops.ROUNDS["rounds"]
        a = step(name, lambda call=call, shape=shape: call(
            app.random_state(MR_SEED), shape, (rows, shape[1])))
        rounds[name] = random_ops.ROUNDS["rounds"] - r
        if checks:
            laws[name] = _mr_law(torch, a, name, mean, var, lo, hi, integer)
        keep(name, a)
        del a
        _mesh_free(torch)
    # the round count: a 1M x 100 draw on the mesh, bit for bit rank 0's
    # serial draw of the same shape (an exact hash of bits at places)
    if checks and app.backend.mesh is not None:
        from nums_tpu_torch.core.array.random import NumsRandomState
        from nums_tpu_torch.core.backend import SerialBackend

        m, w = cfg["rounds_check"]
        for name in ("poisson_30", "binomial"):
            call = MR_LAWS[name][0]
            a = call(app.random_state(MR_SEED + 1), (m, w),
                     (-(-m // world), w))
            got = _sh_sum(torch, _sh_result_hash(torch, app, a))
            h = torch.zeros((), dtype=torch.int64, device=got.device)
            if dist.get_rank() == 0:
                s = call(NumsRandomState(SerialBackend(
                    app.backend.device).init(), MR_SEED + 1), (m, w), (m, w))
                h = _sh_hash(torch, s.raw, 0, w)
                del s
            want = _sh_sum(torch, h)
            _mr_hold(torch.equal(got, want), (name, "mesh vs serial draw",
                                              int(got), int(want)))
            del a
    out["laws"], out["rounds"] = laws, rounds
    mvn_mean = np.arange(cfg["mvn"]) / cfg["mvn"]
    mvn_cov = np.eye(cfg["mvn"]) + 0.5
    a = step("multivariate_normal", lambda: app.random_state(
        MR_SEED).multivariate_normal(mvn_mean, mvn_cov, shape=(n,),
                                     block_shape=(rows, cfg["mvn"]),
                                     dtype=np.float32))
    if checks:
        loc = _local(a).to(torch.float64)
        s = torch.zeros((3, cfg["mvn"]), dtype=torch.float64,
                        device=loc.device)
        if app.backend.counts_here(a.raw.placements):
            s[0], s[1] = loc.sum(0), (loc * loc).sum(0)
            s[2] = (loc * loc[:, :1]).sum(0)
        s = _sh_sum(torch, s).reshape(3, cfg["mvn"]) / n
        mean = s[0].cpu().numpy()
        var = (s[1] - s[0] ** 2).cpu().numpy()
        cov0 = (s[2] - s[0] * s[0][0]).cpu().numpy()
        _mr_hold(np.all(np.abs(mean - mvn_mean) <= MR_SIGMAS * np.sqrt(
            1.5 / n)), ("multivariate_normal", "mean"))
        _mr_hold(np.all(np.abs(var - 1.5) <= _mr_var_tol(1.5, n)),
                 ("multivariate_normal", "variance", float(var.min()),
                  float(var.max())))
        _mr_hold(np.all(np.abs(cov0[1:] - 0.5) <= _mr_var_tol(1.5, n)),
                 ("multivariate_normal", "covariance",
                  float(np.abs(cov0[1:] - 0.5).max())))
        del loc
    keep("multivariate_normal", a)
    del a
    a = step("multinomial", lambda: app.random_state(MR_SEED).multinomial(
        20, [1.0 / 16] * 16, shape=(n,), block_shape=(rows, 16),
        dtype=np.int32))
    if checks:
        loc = _local(a)
        _mr_hold(_all_max(torch, float((loc.sum(1) != 20).sum())) == 0.0,
                 ("multinomial", "row sums"))
        laws["multinomial"] = _mr_law(torch, a, "multinomial", 1.25,
                                      20 / 16 * 15 / 16, 0, 20, True)
    keep("multinomial", a)
    del a
    nperm = cfg["perm"]
    a = step("permutation", lambda: app.random_state(MR_SEED).permutation(
        nperm, -(-nperm // world)))
    if checks:
        top, least = _mr_counts(torch, app, _local(a), nperm)
        _mr_hold(top == 1.0 and least == 1.0, ("permutation", top, least))
    keep("permutation", a)
    del a
    _mesh_free(torch)
    if callable(X):
        X, out["x_draw_seconds"] = _mesh_seconds(torch, X)
    # shuffle: X's rows at the places of the same-seed permutation, by an
    # exact hash of their bits (X's own hash taken before, X shuffled in
    # place)
    before = _sh_sum(torch, _sh_result_hash(torch, app, X)) if checks \
        else None
    step("shuffle", lambda: app.random_state(MR_SEED + 2).shuffle(X))
    if checks:
        perm = app.random_state(MR_SEED + 2).permutation(n, rows)
        xl, pv = _local(X), _local(perm).reshape(-1)
        after = torch.zeros((), dtype=torch.int64, device=xl.device)
        for i in range(0, int(xl.shape[0]), 1 << 16):
            after += _sh_hash_at(torch, xl[i:i + (1 << 16)],
                                 pv[i:i + (1 << 16)] * d)
        after = _sh_sum(torch, after)
        del xl, pv
        _mr_hold(torch.equal(after, before), ("shuffle", int(after),
                                              int(before)))
        del perm
    keep("shuffle", X)
    k = cfg["choice"]
    for replace in (True, False):
        name = "choice" if replace else "choice_norep"
        a = step(name, lambda replace=replace: app.random_state(
            MR_SEED + 3).choice(X, shape=(k,), block_shape=(-(-k // world),
                                                            d),
                                replace=replace))
        if checks:
            ind = app.random_state(MR_SEED + 3).choice(
                n, shape=(k,), block_shape=(-(-k // world),),
                replace=replace)
            _mr_rows_check(torch, app, a, ind, X, name)
            top, _ = _mr_counts(torch, app, _local(ind).to(torch.int64), n)
            _mr_hold(replace or top == 1.0, (name, "repeats", top))
            del ind
        keep(name, a)
        del a
        _mesh_free(torch)
    pw = np.arange(1.0, n + 1.0)
    pw /= pw.sum()
    a = step("choice_p", lambda: app.random_state(MR_SEED + 4).choice(
        n, shape=(k,), block_shape=(-(-k // world),), p=pw))
    if checks:
        ev = float((np.arange(n) * pw).sum())
        sd = float(np.sqrt((np.arange(n) ** 2 * pw).sum() - ev * ev))
        laws["choice_p"] = _mr_law(torch, a, "choice_p", ev, sd * sd, 0,
                                   n - 1, True)
    keep("choice_p", a)
    del a, pw
    _mesh_free(torch)
    # pinv of X by TSQR: ‖A·pinv(A)·A − A‖/‖A‖ and ‖pinv(A)·A − I‖ in
    # float64 (each rank's rows a chunk at a time, one all-reduce)
    P = step("pinv", lambda: nps.linalg.pinv(X))
    if checks:
        # the rows of pinv(A)ᵀ: P's raw where the mesh shards X (a lazy
        # transpose), else the transpose of P's whole value
        pl = _local(P) if P.is_transposed else _local(P).T
        xl = _local(X)
        here = app.backend.counts_here(X.raw.placements)
        M = torch.zeros((d, d), dtype=torch.float64, device=xl.device)
        for i in range(0, int(xl.shape[0]) if here else 0, 1 << 18):
            M += pl[i:i + (1 << 18)].to(torch.float64).T @ xl[
                i:i + (1 << 18)].to(torch.float64)
        M = _sh_sum(torch, M).reshape(d, d)
        eye = torch.eye(d, dtype=torch.float64, device=M.device)
        res_i = float(torch.linalg.norm(M - eye))
        num = torch.zeros(2, dtype=torch.float64, device=M.device)
        for i in range(0, int(xl.shape[0]) if here else 0, 1 << 18):
            c = xl[i:i + (1 << 18)].to(torch.float64)
            num[0] += (c @ (M - eye)).pow(2).sum()
            num[1] += c.pow(2).sum()
        num = _sh_sum(torch, num)
        res_a = float(torch.sqrt(num[0] / num[1]))
        out["pinv_residuals"] = {"A_pinvA_A": res_a, "pinvA_A_I": res_i}
        _mr_hold(res_a <= MR_PINV_REL and res_i <= MR_PINV_REL,
                 ("pinv", res_a, res_i))
        del M, pl, xl
    keep("pinv", P)
    del P
    _mesh_free(torch)
    Xs = X[:cfg["la_rows"]]
    R = step("inner", lambda: nps.inner(Xs, Xs))
    if checks:
        out["inner_rel"] = _mr_sampled_rows(
            torch, app, R, Xs, lambda r, x: r @ x.T, "inner")
    keep("inner", R)
    del R
    _mesh_free(torch)
    R = step("cov", lambda: nps.cov(Xs, rowvar=True))
    if checks:
        def cov_rows(r, x):
            xc = x - x.mean(dim=1, keepdim=True)
            return (r - r.mean(dim=1, keepdim=True)) @ xc.T / (x.shape[1] - 1)

        out["cov_rel"] = _mr_sampled_rows(torch, app, R, Xs, cov_rows, "cov")
    keep("cov", R)
    del R, Xs
    _mesh_free(torch)
    nv = cfg["vec"]
    v = app.random_state(MR_SEED + 5).normal(
        shape=(nv,), block_shape=(-(-nv // world),), dtype=np.float32)
    D = step("diag", lambda: nps.diag(v))
    if checks:
        _mr_diag_check(torch, app, D, v, 0, "diag")
    keep("diag", D)
    del D
    _mesh_free(torch)
    D = step("diagflat", lambda: nps.diagflat(v, 1))
    if checks:
        _mr_diag_check(torch, app, D, v, 1, "diagflat")
    keep("diagflat", D)
    del D, v
    _mesh_free(torch)
    return res


def _mr_bounds(cfg, world, d, rounds, x_rows):
    """The bytes a rank may send in each step, beside
    ``SHAPE_SLACK_BYTES``: a looped draw one 4-byte flag a round (and,
    with per-element parameters, one that says whether the rejection
    branch runs, by category for the multinomial), by the ring count
    2·(p − 1)/p of an all-reduce; a draw by position none; the
    permutation's rounds, each a sample sort of a 4 B key and an 8 B
    value an element (the share that leaves a rank, (p − 1)/p) and the
    placing of the 8 B values; shuffle that and its slab of X with an 8 B
    position a row sent twice; a choice its rows and their positions (and
    without replacement a permutation of X's rows); pinv CholeskyQR2's
    two d×d all-reduces; the ring of rows p − 1 shards of X's first rows;
    diag and diagflat their box's diagonal."""
    off = (world - 1) / world
    flag = 2 * (world - 1) * 4 // max(world, 1)
    n = cfg["n"]
    m = -(-cfg["perm"] // world)

    def perm(count, elems):
        rounds_p = int(np.ceil(3 * np.log(max(1, count))
                               / np.log(2 ** 32 - 1)))
        return int(rounds_p * (off * 12 + 8) * elems)

    k = -(-cfg["choice"] // world)
    xr = x_rows * d * 4
    out = {name: (rounds.get(name, 0) + 17) * flag for name in MR_LAWS}
    out.update({
        "multivariate_normal": 0, "multinomial": 40 * flag,
        "permutation": perm(cfg["perm"], m),
        "shuffle": perm(n, x_rows) + xr + 16 * x_rows,
        "choice": k * (d * 4 + 16),
        "choice_norep": k * (d * 4 + 16) + perm(n, x_rows) + 16 * k,
        "choice_p": 0,
        "pinv": 4 * d * d * flag,
        "inner": (world - 1) * -(-cfg["la_rows"] // world) * d * 4,
        "cov": (world - 1) * -(-cfg["la_rows"] // world) * d * 4,
        "diag": 8 * cfg["vec"], "diagflat": 8 * cfg["vec"]})
    return out


def _mr_held(torch, info, bounds, x_bytes):
    """Every step: no all-gather inside a torch op, no kernel launched,
    its bytes within its bound, its peak below X's bytes (on the cards of
    a mesh of several; ``x_bytes`` None on one, which holds X whole)."""
    for name, st in info.items():
        _mr_hold("all_gather_into_tensor" not in st["collectives"], (
            name, st["collectives"]))
        _mr_hold(not st["launches"], (name, st["launches"]))
        _mr_hold(st["bytes_sent"] <= bounds[name] + SHAPE_SLACK_BYTES, (
            name, st["bytes_sent"], bounds[name]))
        _mr_hold(DEVICE != "cuda" or x_bytes is None
                 or st["peak_bytes"] < x_bytes, (name, st["peak_bytes"]))


def _mr_step_fn(torch, info):
    """The ``step`` of ``_mr_steps``: each step once (nothing compiles),
    its seconds (host clock after a barrier, the slowest rank's), the
    bytes this rank sent through the port's collectives, the collectives
    ``CommDebugMode`` saw, the kernel launches (set to 0 just before it,
    read just after) and the peak."""
    from torch.distributed.tensor.debug import CommDebugMode

    from nums_tpu_torch.core import multiprocess

    def step(name, fn):
        _mesh_free(torch)
        sent = multiprocess.SENT["bytes"]
        _reset_counts()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mode = CommDebugMode()
        with mode:
            res, secs = _mesh_seconds(torch, fn)
        info[name] = {"seconds": secs,
                      "bytes_sent": multiprocess.SENT["bytes"] - sent,
                      "collectives": {str(k).split(".")[-1]: v for k, v in
                                      mode.get_comm_counts().items() if v},
                      "launches": {k: v for k, v in _counts().items() if v},
                      "peak_bytes": _mesh_peak(torch)}
        # each step as it ends (the phase's line comes after every check)
        print(json.dumps({"mesh_random_step": name, **info[name]}),
              flush=True)
        return res

    return step


def phase_mesh_random(torch, smi, app, X):
    """Phase 20 in the full run, on phase 15's world-1 mesh: a copy of X's
    first ``MR_WORLD1["n"]`` rows and the steps at ``MR_WORLD1``'s depth,
    on the mesh and again on the serial backend with the same tensors
    (each run shuffles its own copy), every result bit for bit equal and
    held to its check; no kernel launched."""
    from nums_tpu_torch.core import application_manager
    from nums_tpu_torch.core.array.blockarray import BlockArray

    t_phase = time.perf_counter()
    n = MR_WORLD1["n"]
    mesh_app = application_manager._instance
    rows = _local(X)[:n]
    info, out = {}, {}
    cfg = {**MR_WORLD1, "d": D_FULL}
    got = _mr_steps(torch, app, BlockArray.from_torch(
        rows.clone(), (n, D_FULL), app.backend), cfg,
        _mr_step_fn(torch, info), out, keep_all=True)
    serial = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE)
    application_manager.set_instance(serial)
    try:
        ref = _mr_steps(torch, serial, BlockArray.from_torch(
            rows.clone(), (n, D_FULL), serial.backend), cfg,
            lambda name, fn: fn(), {}, checks=False, keep_all=True)
    finally:
        application_manager.set_instance(mesh_app)
    differ = _same_results(torch, got, ref)
    _mr_hold(not differ, ("mesh vs serial", differ))
    bounds = _mr_bounds(MR_WORLD1, 1, D_FULL, out["rounds"], n)
    _mr_held(torch, info, bounds, None)
    launches = {name: sum(st["launches"].get(name, 0)
                          for st in info.values()) for name, _, _ in KERNELS}
    out.update({"phase": "mesh_random", "world": 1, "shape": [n, D_FULL],
                "nvidia_smi": smi, "steps": info, "launches": launches,
                "bitwise_vs_serial": sorted(got), "failed": MR_FAILED,
                "seconds": time.perf_counter() - t_phase})
    del got, ref, rows
    _mesh_free(torch)
    emit(out)
    assert not MR_FAILED, MR_FAILED
    assert sum(launches.values()) == 0, launches
    return out


def _mr_cards(torch, cfg):
    """--mesh-random-only on this rank: X of 10M x 1000 fp32 drawn on the
    (cards, 1) mesh from phase 4's seed, then ``_mr_steps`` with every
    check; each step held to its bytes, no all-gather inside a torch op,
    no kernel, its peak below X's bytes; rank 0 prints the phase's
    line."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager

    world = dist.get_world_size()
    n, d = cfg["n"], cfg["d"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if dist.get_rank() == 0 else (
        lambda obj: print(json.dumps(obj)))
    t0 = time.perf_counter()
    info, out = {}, {}
    _mr_steps(torch, app, lambda: _draw_mesh_x(torch, app, n, d), cfg,
              _mr_step_fn(torch, info), out)
    bounds = _mr_bounds(cfg, world, d, out["rounds"], -(-n // world))
    _mr_held(torch, info, bounds, 4 * n * d)
    peaks = [None] * world
    dist.all_gather_object(peaks, max(st["peak_bytes"]
                                      for st in info.values()))
    launches = [None] * world
    dist.all_gather_object(launches, {
        name: sum(st["launches"].get(name, 0) for st in info.values())
        for name, _, _ in KERNELS})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "mesh_random", "world": world, "shape": [n, d],
         "cluster_shape": [world, 1], **out,
         "steps": info, "bounds": bounds, "peak_bytes_per_card": peaks,
         "launches_per_card": launches, "nvidia_smi_per_card": smi,
         "failed": MR_FAILED, "seconds": time.perf_counter() - t0})
    assert all(sum(c.values()) == 0 for c in launches), launches
    assert not MR_FAILED, MR_FAILED


def phase_mesh_random_cards(torch, smi):
    """--mesh-random-only: one process per visible card, as --shape-only
    spawns them, each running ``_mr_cards``; fails unless every rank
    exits 0 before ``MR_DEADLINE_S``. Returns the number of ranks."""
    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    cfg = {**MR_FULL, "d": D_FULL, "device": DEVICE,
           "deadline": MR_DEADLINE_S, "out_dir": out_dir, "root": root,
           "entry": "_mr_cards"}
    emit({"phase": "mesh_random_start", "world": world, "nvidia_smi": smi,
          "shape": [cfg["n"], cfg["d"]]})
    t0 = time.perf_counter()
    codes = _spawn_ranks(world, cfg)
    assert codes == [0] * world, ("mesh_random ranks' exit codes", codes)
    emit({"phase": "mesh_random_done", "world": world, "exit_codes": codes,
          "seconds": time.perf_counter() - t0})
    return world


# -- Phase 21: the signal ops on the mesh (mesh_signal) ------------------
# The distributed 1-D FFT of a sharded vector (four-step, Bluestein), the
# n-D FFT and the shift without whole copies, convolve/correlate/polymul of
# two sharded operands (the shorter on a ring), poly of sharded roots and
# quantiles at a sharded q. With --mesh-signal-only on every card
# (SIG_FULL: a vector of 2.5e9 = 2^8·5^10, four-step 50,000 x 50,000; the
# prime 999,999,937, Bluestein over M = 2^31; X at 10M x 1000); in the full
# run on phase 15's world-1 mesh at SIG_WORLD1, every result bit for bit
# the serial backend's.
SIG_FULL = {"n": MESH_N, "vec": 2_500_000_000, "prime": 999_999_937,
            "signal": 100_000_000, "taps": 1 << 18, "poly": 1 << 20,
            "roots": 1 << 16, "q": 1_000_000}
SIG_WORLD1 = {"n": 100_000, "vec": 1 << 24, "prime": 9_999_991,
              "signal": 1_000_000, "taps": 1 << 12, "poly": 1 << 14,
              "roots": 1 << 12, "q": 10_000}
SIG_SEED = LA_SEED + 21
SIG_DEADLINE_S = 1000.0      # every rank exits 0 within, or the run fails
SIG_BINS = 64                # bins of a transform held to a float64 DFT
SIG_X_BINS = 8               # ... of fft2(X)
# (bin, amplitude) of the tones planted in the vectors (a negative bin
# counts from the end); the real vector takes the amplitude's modulus
SIG_TONES = ((12_345, 0.1), (-7_777, 0.05j))
SIG_NAN_EVERY = 1000         # NaNs planted for nanquantile
SIG_SAMPLES = 64             # quantile results held to all-reduced counts
SIG_POINTS = 16              # poly evaluated on the unit circle there
SIG_ROOT_SCALE = 2.0 ** -16  # poly's roots: uniform in ±this
SIG_POLY_REL = 1e-5          # float32 coefficients: 2^-24·log2(roots)·Σ|c|
SIG_CHUNK = 1 << 18          # positions of a float64 reference at a time
SIG_SLACK_BYTES = 64 << 20   # counts, splitters and flags beside the moves
SIG_FAILED = []


def _sig_fft_rel(n):
    """The limit of a float32 transform of length n, of ‖x‖₂ a bin (and a
    round trip's ‖y − x‖₂, Parseval's Σ|X|² against n·Σ|x|²): 5·2^-24·
    log2(n)."""
    return 5 * 2.0 ** -24 * float(np.log2(n))


def _sig_conv_rel(k):
    """The limit of a float32 sum of k products against float64, of the
    largest output: 4·2^-24·√k (roundings of partial sums of size √k, in
    sequence, four times their typical sum)."""
    return 4 * 2.0 ** -24 * float(np.sqrt(k))


def _sig_hold(ok, what):
    if not ok:
        SIG_FAILED.append(repr(what))


def _sig_start(app, a):
    """The first position of this rank's part of a 1-D BlockArray."""
    if app.backend.mesh is None:
        return 0
    return app.backend.region(tuple(a.shape), a.raw.placements)[0][0]


def _sig_here(app, a):
    """Whether this rank's part counts in a sum over the ranks."""
    return app.backend.mesh is None or app.backend.counts_here(
        a.raw.placements)


def _sig_sum(torch, t):
    """A float64 or complex128 tensor summed over every rank."""
    import torch.distributed as dist

    t = t.reshape(-1).to(_mesh_device(torch)).clone()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t)
    return t


def _sig_tones(torch, loc, start, n, real):
    """``SIG_TONES`` added to this rank's part ``loc`` (positions from
    ``start``) of a vector of n: amp·exp(2πi·k·j/n), or |amp|·cos(2π·k·j/n)
    for a real one, from exact (k·j mod n)."""
    for k0, amp in SIG_TONES:
        k = k0 % n
        for c0 in range(0, int(loc.numel()), SIG_CHUNK * 16):
            c1 = min(int(loc.numel()), c0 + SIG_CHUNK * 16)
            j = torch.arange(start + c0, start + c1, dtype=torch.int64,
                             device=loc.device)
            ang = ((j * k) % n).to(torch.float64) * (2 * np.pi / n)
            if real:
                loc[c0:c1] += (abs(amp) * torch.cos(ang)).to(loc.dtype)
            else:
                loc[c0:c1] += (amp * torch.polar(torch.ones_like(ang),
                                                 ang)).to(loc.dtype)


def _sig_vector(torch, app, n, seed, kind, tones=False):
    """A vector of n drawn sharded over the mesh from ``seed``: "complex"
    (complex64 of two float32 normal draws), "real" (float32 normals) or
    "roots" (float32 uniform in ±``SIG_ROOT_SCALE``); with ``tones``,
    ``SIG_TONES`` planted."""
    from nums_tpu_torch.core.array.blockarray import BlockArray
    from nums_tpu_torch.core.grid import ArrayGrid
    from nums_tpu_torch.core.ops import mesh_ops

    blocks = (-(-n // app.backend.num_devices),)
    rs = app.random_state(seed)
    if kind == "roots":
        return rs.uniform(-SIG_ROOT_SCALE, SIG_ROOT_SCALE, shape=(n,),
                          block_shape=blocks, dtype=np.float32)
    v = rs.normal(shape=(n,), block_shape=blocks, dtype=np.float32)
    if kind == "complex":
        im = rs.normal(shape=(n,), block_shape=blocks, dtype=np.float32)
        loc = torch.complex(_local(v), _local(im))
        del im
        v = BlockArray(mesh_ops.like(v.raw, loc), ArrayGrid(
            (n,), blocks, "complex64"), app.backend)
    if tones:
        _sig_tones(torch, _local(v), _sig_start(app, v), n,
                   kind == "real")
    return v


def _sig_values_at(torch, app, a, idx):
    """The elements ``idx`` (host ints) of a 1-D BlockArray, complex128, on
    every rank (its holders' values, one all-reduce)."""
    loc = _local(a)
    lo = _sig_start(app, a)
    at = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                         device=loc.device) - lo
    vals = torch.zeros(len(idx), dtype=torch.complex128, device=loc.device)
    if _sig_here(app, a):
        mine = (at >= 0) & (at < loc.numel())
        vals[mine] = loc[at[mine]].to(torch.complex128)
    return _sig_sum(torch, vals)


def _sig_energy(torch, app, a, b=None):
    """Σ|a|² (with ``b``, Σ|a − b|², both laid out alike) over every rank,
    in float64, a chunk at a time."""
    loc = _local(a).reshape(-1)
    other = None if b is None else _local(b).reshape(-1)
    s = torch.zeros((1,), dtype=torch.float64, device=loc.device)
    if _sig_here(app, a):
        for c0 in range(0, int(loc.numel()), SIG_CHUNK * 64):
            c = loc[c0:c0 + SIG_CHUNK * 64].to(torch.complex128)
            if other is not None:
                c = c - other[c0:c0 + SIG_CHUNK * 64].to(torch.complex128)
            s += (c.real * c.real + c.imag * c.imag).sum()
    return float(_sig_sum(torch, s)[0])


def _sig_dft64(torch, app, x, bins, n):
    """The DFT of the 1-D BlockArray x at ``bins`` by the direct float64 sum
    over every rank's part (each phase from exact (j·k mod n); one
    distributed dot product a bin, all bins a chunk of positions at a
    time)."""
    loc = _local(x)
    lo = _sig_start(app, x)
    kb = torch.as_tensor(np.asarray(bins, dtype=np.int64), device=loc.device)
    acc = torch.zeros(len(bins), dtype=torch.complex128, device=loc.device)
    if _sig_here(app, x):
        for c0 in range(0, int(loc.numel()), SIG_CHUNK):
            c1 = min(int(loc.numel()), c0 + SIG_CHUNK)
            j = torch.arange(lo + c0, lo + c1, dtype=torch.int64,
                             device=loc.device)
            ang = ((j[:, None] * kb[None, :]) % n).to(torch.float64) * (
                -2 * np.pi / n)
            acc += loc[c0:c1].to(torch.complex128) @ torch.polar(
                torch.ones_like(ang), ang)
    return _sig_sum(torch, acc)


def _sig_bins(n, out_len, seed):
    """((amplitude, bin) of the tones that the output holds, ``SIG_BINS``
    bins of a transform of n: those tones' bins, 0, the last, and random
    ones)."""
    rs = np.random.RandomState(seed)
    tones = [(amp, k % n) for k, amp in SIG_TONES if k % n < out_len]
    rest = rs.randint(0, out_len, SIG_BINS - len(tones) - 2)
    return tones, [int(b) for b in [k for _, k in tones] + [0, out_len - 1]
                   + list(rest)]


def _sig_dft_check(torch, app, x, F, n, what, rel, half=False):
    """A transform F of x (length n, or its n // 2 + 1 bins with ``half``)
    held to: Parseval's identity in float64, ``SIG_BINS`` bins against
    the direct float64 DFT (each within ``rel``·(‖x‖₂ + |X[k]|): a bin's
    roundings scale with the partial sums that reach it, about ‖x‖₂ for
    the noise and |X[k]| itself at a planted tone, where amp·n is far
    above ‖x‖₂) and the planted tones found at their bins (within 6
    standard errors of the noise)."""
    out_len = int(F.shape[0])
    energy_x = _sig_energy(torch, app, x)
    norm_x = float(np.sqrt(energy_x))
    energy_f = _sig_energy(torch, app, F)
    if half:
        ends = _sig_values_at(torch, app, F, [0, out_len - 1])
        e = [float(abs(v) ** 2) for v in ends.tolist()]
        energy_f = 2 * energy_f - e[0] - (e[1] if n % 2 == 0 else 0.0)
    parseval = abs(energy_f - n * energy_x) / (n * energy_x)
    _sig_hold(parseval <= rel, (what, "parseval", parseval))
    tones, bins = _sig_bins(n, out_len, SIG_SEED + n % 997)
    got = _sig_values_at(torch, app, F, bins)
    ref = _sig_dft64(torch, app, x, bins, n)
    diff = (got - ref).abs()
    err = float((diff / (norm_x + ref.abs())).max())
    _sig_hold(err <= rel, (what, "bins", err))
    noise = float(diff[len(tones):].max()) / norm_x
    # a tone: amp·n (amp/2·n real) beside noise of std √(2n) (√(n/2))
    real = not x.raw.is_complex()
    tone_err = 0.0
    for (amp, k), v in zip(tones, got.tolist()):
        want = abs(amp) * n / 2 if real else amp * n
        dev = abs(v - want) / (6 * np.sqrt(n / 2 if real else 2 * n))
        tone_err = max(tone_err, dev)
    _sig_hold(tone_err <= 1.0, (what, "tones", tone_err))
    return {"parseval_rel": parseval,
            "bins_err_over_norm_and_value": err,
            "noise_bins_err_over_norm": noise,
            "tone_dev_over_6_sigma": tone_err, "limit": rel,
            "bins": len(bins)}


def _sig_round_trip(torch, app, x, y, what, rel):
    err = float(np.sqrt(_sig_energy(torch, app, y, x)
                        / _sig_energy(torch, app, x)))
    _sig_hold(err <= rel, (what, "round trip", err))
    return {"round_trip_rel": err, "limit": rel}


def _sig_shift_check(torch, app, F, S, n):
    """fftshift(F): ``SIG_BINS`` positions i hold F[(i − n // 2) mod n]
    bit for bit."""
    rs = np.random.RandomState(SIG_SEED)
    pos = [0, n - 1] + [int(i) for i in rs.randint(0, n, SIG_BINS - 2)]
    a = _sig_values_at(torch, app, S, pos)
    b = _sig_values_at(torch, app, F, [(i - n // 2) % n for i in pos])
    same = bool(torch.equal(a, b))
    _sig_hold(same, ("fftshift", "positions"))
    return {"positions_equal": same, "positions": len(pos)}


def _sig_fft2_check(torch, app, X, G):
    """fft2(X) of an (n, d) X: Parseval's identity and ``SIG_X_BINS`` bins
    against the direct float64 sum over every rank's rows, each within
    5·2^-24·log2(n·d) of ‖X‖₂."""
    n, d = (int(s) for s in X.shape)
    rel = _sig_fft_rel(n * d)
    energy_x = _sig_energy(torch, app, X)
    parseval = abs(_sig_energy(torch, app, G) - n * d * energy_x) / (
        n * d * energy_x)
    _sig_hold(parseval <= rel, ("fft2", "parseval", parseval))
    rs = np.random.RandomState(SIG_SEED + 2)
    bins = [(0, 0)] + [(int(rs.randint(n)), int(rs.randint(d)))
                       for _ in range(SIG_X_BINS - 1)]
    xl, gl = _local(X), _local(G)
    dev = xl.device
    r0 = app.backend.region((n, d), X.raw.placements)[0][0] \
        if app.backend.mesh is not None else 0
    k1 = torch.tensor([b[0] for b in bins], dtype=torch.int64, device=dev)
    k2 = torch.tensor([b[1] for b in bins], dtype=torch.int64, device=dev)
    j2 = torch.arange(d, dtype=torch.int64, device=dev)
    a2 = ((j2[:, None] * k2[None, :]) % d).to(torch.float64) * (
        -2 * np.pi / d)
    e2 = torch.polar(torch.ones_like(a2), a2)
    ref = torch.zeros(len(bins), dtype=torch.complex128, device=dev)
    got = torch.zeros_like(ref)
    rows = max(1, SIG_CHUNK // d)
    for c0 in range(0, int(xl.shape[0]), rows):
        c1 = min(int(xl.shape[0]), c0 + rows)
        j1 = torch.arange(r0 + c0, r0 + c1, dtype=torch.int64, device=dev)
        a1 = ((j1[:, None] * k1[None, :]) % n).to(torch.float64) * (
            -2 * np.pi / n)
        inner = xl[c0:c1].to(torch.complex128) @ e2
        ref += (inner * torch.polar(torch.ones_like(a1), a1)).sum(0)
    for i, (b1, b2) in enumerate(bins):
        if r0 <= b1 < r0 + int(gl.shape[0]):
            got[i] = gl[b1 - r0, b2].to(torch.complex128)
    ref, got = _sig_sum(torch, ref), _sig_sum(torch, got)
    err = float((got - ref).abs().max()) / float(np.sqrt(energy_x))
    _sig_hold(err <= rel, ("fft2", "bins", err))
    return {"parseval_rel": parseval, "bins_err_over_norm": err,
            "limit": rel, "bins": len(bins)}


def _sig_whole64(torch, app, a):
    """A small sharded 1-D BlockArray whole on every rank, in float64 (a
    check's reference input: one all-gather)."""
    loc = _local(a).to(torch.float64)
    if app.backend.mesh is None:
        return loc
    if not _sig_here(app, a):
        loc = loc[:0]
    return _mc_gather_vec(torch, loc, _sig_start(app, a))


def _sig_conv64(torch, xw, ker, outs):
    """Σ_i xw[o + i]·ker[i] for o < ``outs`` in float64, by a float64
    FFT."""
    m = int(ker.shape[0])
    size = 1 << int(xw.shape[0] + m - 1).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(xw, size)
                           * torch.fft.rfft(torch.flip(ker, (0,)), size),
                           size)
    return full[m - 1:m - 1 + outs]


def _sig_conv_check(torch, app, v, k, res, op, mode):
    """``op`` of the signal v by the sharded kernel k in ``mode``: each
    rank's first and last 2(m − 1) outputs (their inputs cross into the
    neighbours' parts) and an interior window held to float64 (the kernel
    read whole for the check, the halo from the neighbours' edges)."""
    n, m = int(v.shape[0]), int(k.shape[0])
    lv = _local(v).double()
    a = _sig_start(app, v)
    b = a + int(lv.shape[0])
    kk = _sig_whole64(torch, app, k)
    ker = torch.flip(kk, (0,)) if op == "convolve" else kk
    edges = _mc_edges(torch, lv, a, b, 4 * m)
    local = _local(res)
    o0 = _sig_start(app, res)
    o1 = o0 + int(local.shape[0])
    pad = {"valid": 0, "same": m // 2, "full": m - 1}[mode]
    lo = max(o0, a + pad)
    edge = 2 * (m - 1)
    pieces = [(o0, min(o1, o0 + edge)), (max(o0, o1 - edge), o1),
              (lo, min(o1, b + pad - m + 1, lo + MC_CONV_CHECK))]
    err, scale = 0.0, 0.0
    for s0, s1 in pieces:
        if s1 <= s0:
            continue
        xw = _mc_window(torch, lv, a, b, edges, s0 - pad, s1 - pad + m - 1,
                        n)
        want = _sig_conv64(torch, xw, ker, s1 - s0)
        err = max(err, float((local[s0 - o0:s1 - o0].double()
                              - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    err = _mc_sum(torch, err, "max") / _mc_sum(torch, scale, "max")
    rel = _sig_conv_rel(m)
    _sig_hold(err <= rel, (op, mode, err))
    return {"halo_and_interior_rel_err_vs_f64": err, "limit": rel,
            "length": int(res.shape[0])}


def _sig_polymul_check(torch, app, p1, p2, res):
    """polymul of two sharded polynomials: each rank's coefficients held
    to the float64 product (both operands read whole for the check)."""
    a, b = _sig_whole64(torch, app, p1), _sig_whole64(torch, app, p2)
    want = _sig_conv64(torch, torch.nn.functional.pad(
        a, (b.shape[0] - 1, b.shape[0] - 1)), torch.flip(b, (0,)),
        a.shape[0] + b.shape[0] - 1)
    local = _local(res).double()
    o0 = _sig_start(app, res)
    err = float((local - want[o0:o0 + local.shape[0]]).abs().max()) \
        if local.numel() else 0.0
    err = _mc_sum(torch, err, "max") / float(want.abs().max())
    rel = _sig_conv_rel(min(a.shape[0], b.shape[0]))
    _sig_hold(err <= rel, ("polymul", err))
    return {"rel_err_vs_f64": err, "limit": rel,
            "length": int(res.shape[0])}


def _sig_poly_check(torch, app, z, res):
    """poly of the sharded roots z, evaluated at ``SIG_POINTS`` points
    t = exp(πi·(2j + 1)/16) of the unit circle (each power from exact
    integers) against the float64 product Π(t − zᵢ) over every rank."""
    deg = int(z.shape[0])
    dev = _local(z).device
    odd = torch.arange(1, 2 * SIG_POINTS, 2, dtype=torch.int64, device=dev)
    t = torch.polar(torch.ones(SIG_POINTS, dtype=torch.float64, device=dev),
                    odd.to(torch.float64) * (np.pi / SIG_POINTS))
    c = _local(res).to(torch.complex128)
    k0 = _sig_start(app, res)
    e = deg - torch.arange(k0, k0 + c.shape[0], dtype=torch.int64,
                           device=dev)
    ang = ((e[:, None] * odd[None, :]) % (2 * SIG_POINTS)).to(
        torch.float64) * (np.pi / SIG_POINTS)
    val = (c[:, None] * torch.polar(torch.ones_like(ang), ang)).sum(0) \
        if _sig_here(app, res) else torch.zeros_like(t)
    val = _sig_sum(torch, val)
    zl = _local(z).to(torch.complex128)
    part = (t[None, :] - zl[:, None]).prod(0) if _sig_here(app, z) \
        else torch.ones_like(t)
    import torch.distributed as dist

    parts = [part]
    if dist.is_initialized() and dist.get_world_size() > 1:
        parts = [torch.empty_like(part) for _ in range(
            dist.get_world_size())]
        dist.all_gather(parts, part)
    ref = torch.stack(parts).prod(0)
    err = float(((val - ref).abs() / ref.abs()).max())
    _sig_hold(err <= SIG_POLY_REL, ("poly", err))
    return {"points": SIG_POINTS, "rel_err_vs_f64_product": err,
            "limit": SIG_POLY_REL, "degree": deg}


def _sig_quantile_check(torch, app, v, q, res, what):
    """Quantiles of v at q: ``SIG_SAMPLES`` results r, each between the
    order statistics of its positions low ≤ q·(n − 1) ≤ high (n the values
    that are not NaN): the all-reduced counts #{v ≤ r} ≥ low + 1 and
    #{v < r} ≤ high."""
    k = int(q.shape[0])
    rs = np.random.RandomState(SIG_SEED + 3)
    idx = [0, k - 1] + [int(i) for i in rs.randint(0, k, SIG_SAMPLES - 2)]
    r = _sig_values_at(torch, app, res, idx).real
    qv = _sig_values_at(torch, app, q, idx).real
    loc = _local(v)
    order = torch.argsort(r)
    bounds = r[order].to(device=loc.device, dtype=loc.dtype)
    le = torch.zeros(len(idx) + 1, dtype=torch.float64, device=loc.device)
    lt = torch.zeros_like(le)
    valid = torch.zeros((1,), dtype=torch.float64, device=loc.device)
    if _sig_here(app, v):
        for c0 in range(0, int(loc.numel()), SIG_CHUNK * 64):
            c = loc[c0:c0 + SIG_CHUNK * 64]
            c = c[~torch.isnan(c)]
            valid += c.numel()
            le += torch.bincount(torch.bucketize(c, bounds),
                                 minlength=len(idx) + 1).double()
            lt += torch.bincount(torch.bucketize(c, bounds, right=True),
                                 minlength=len(idx) + 1).double()
    le, lt, valid = (_sig_sum(torch, t) for t in (le, lt, valid))
    c_le = torch.empty_like(r)
    c_lt = torch.empty_like(r)
    c_le[order] = torch.cumsum(le, 0)[:-1].to(r.device)
    c_lt[order] = torch.cumsum(lt, 0)[:-1].to(r.device)
    pos = qv * (float(valid[0]) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    ok = bool(((c_le >= low + 1) & (c_lt <= high)).all())
    _sig_hold(ok, (what, "bracketing"))
    return {"samples": len(idx), "bracketed": ok, "values": float(valid[0])}


def _sig_bounds(cfg, world, d):
    """The bytes a rank may send in each step, beside ``SIG_SLACK_BYTES``
    (off = (P − 1)/P; a shard is ⌈n/P⌉ elements):
    * the four-step moves its complex64 shard three times, keeping 1/P
      each time (the runs of the vector are already whole rows of the
      50,000 × 50,000 view, and the output's runs its boxes): 24·off a
      position; rfft's half output then moves once more (8 B a position
      of the shard), irfft's Hermitian extension reads each input shard
      at most twice (16 B a position of its shard of n / 2 + 1);
    * Bluestein: three transforms of M = 2^31 (72·off a position of the
      M-shard), the input's runs to whole rows of (2^15, 2^16) (8 B a
      position of the n-shard) and its first n outputs back from those
      rows (8 B a position of the M-shard, of at most n);
    * fftshift: each position of the shard once (8 B); fft2 of X: the
      columns made local and back, 4 B out and 8 B back, off each;
    * the ring: P − 1 shards of the kernel (4 B), the halo 4·4m, the
      polynomials' whole shards of x to every other rank;
    * the quantiles: the sample sort of v (4·off + 4 B an element,
      ``_shape_bounds``) and 24 B a q of this rank (8 B a position out,
      4 B a value back, two of each)."""
    from nums_tpu_torch.core.ops import mesh_fft

    off = (world - 1) / world

    def shard(n):
        return -(-n // world)

    n, nd = cfg["vec"], shard(cfg["n"]) * d
    M = mesh_fft.bluestein_length(cfg["prime"], world)
    m, mp = cfg["taps"], cfg["poly"]
    sort = int((4 * off + 4) * shard(n))
    return {"fft": int(24 * off * shard(n)), "fftshift": 8 * shard(n),
            "ifft": int(24 * off * shard(n)),
            "rfft": int(24 * off * shard(n)) + 8 * shard(n),
            "irfft": int(24 * off * shard(n)) + 16 * shard(n // 2 + 1),
            "fft_prime": int(72 * off * shard(M)) + 8 * shard(
                cfg["prime"]) + 8 * min(shard(M), cfg["prime"]),
            "fft2": int(12 * off * nd),
            "convolve": 4 * (world - 1) * shard(m) + 16 * m,
            "correlate": 4 * (world - 1) * shard(m) + 16 * m,
            "polymul": 8 * (world - 1) * shard(mp), "poly": 0,
            "quantile": sort + 24 * shard(cfg["q"]),
            "nanquantile": sort + 24 * shard(cfg["q"])}


def _sig_held(torch, info, bounds, x_bytes):
    """Every step: no all-gather inside a torch op, no kernel launched,
    its bytes within its bound, its peak below X's bytes (on the cards of
    a mesh of several; None on one, which holds X whole)."""
    for name, st in info.items():
        _sig_hold("all_gather_into_tensor" not in st["collectives"], (
            name, st["collectives"]))
        _sig_hold(not st["launches"], (name, st["launches"]))
        _sig_hold(st["bytes_sent"] <= bounds[name] + SIG_SLACK_BYTES, (
            name, st["bytes_sent"], bounds[name]))
        _sig_hold(DEVICE != "cuda" or x_bytes is None
                  or st["peak_bytes"] < x_bytes, (name, st["peak_bytes"]))


def _sig_steps(torch, app, X, cfg, step, out, checks=True, keep=False):
    """Phase 21's steps through the facade (``nps``) on ``app``, each
    through ``step(name, fn)``, each held to its check where ``checks``;
    X is an array or a function that draws it (freed after its step).
    Returns the results by name where ``keep`` (to compare two runs)."""
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core.ops import mesh_fft

    got = {}
    world = app.backend.num_devices
    N = cfg["vec"]
    rel = _sig_fft_rel(N)
    # the four-step: fft, its shift, the inverse
    x = _sig_vector(torch, app, N, SIG_SEED, "complex", tones=True)
    F = step("fft", lambda: nps.fft.fft(x))
    if checks:
        out["fft"] = _sig_dft_check(torch, app, x, F, N, "fft", rel)
    S = step("fftshift", lambda: nps.fft.fftshift(F))
    if checks:
        out["fftshift"] = _sig_shift_check(torch, app, F, S, N)
    if keep:
        got["fftshift"] = S
    del S
    _mesh_free(torch)
    B = step("ifft", lambda: nps.fft.ifft(F))
    if checks:
        out["ifft"] = _sig_round_trip(torch, app, x, B, "ifft", rel)
    if keep:
        got.update(fft=F, ifft=B)
    del x, F, B
    _mesh_free(torch)
    # the real transforms of the float32 vector
    v = _sig_vector(torch, app, N, SIG_SEED + 1, "real", tones=True)
    R = step("rfft", lambda: nps.fft.rfft(v))
    if checks:
        out["rfft"] = _sig_dft_check(torch, app, v, R, N, "rfft", rel,
                                     half=True)
    B = step("irfft", lambda: nps.fft.irfft(R, n=N))
    if checks:
        out["irfft"] = _sig_round_trip(torch, app, v, B, "irfft", rel)
    if keep:
        got.update(rfft=R, irfft=B)
    del R, B
    _mesh_free(torch)
    # Bluestein at a prime length
    p = cfg["prime"]
    M = mesh_fft.bluestein_length(p, world)
    xp = _sig_vector(torch, app, p, SIG_SEED + 2, "complex", tones=True)
    F = step("fft_prime", lambda: nps.fft.fft(xp))
    if checks:
        out["fft_prime"] = _sig_dft_check(torch, app, xp, F, p, "fft_prime",
                                          3 * _sig_fft_rel(M))
        out["fft_prime"]["bluestein_length"] = M
    if keep:
        got["fft_prime"] = F
    del xp, F
    _mesh_free(torch)
    # the quantiles of v at a sharded q, and with NaNs planted
    k = cfg["q"]
    q = app.linspace(0.0, 1.0, (k,), (-(-k // world),))
    Q = step("quantile", lambda: nps.quantile(v, q))
    if checks:
        out["quantile"] = _sig_quantile_check(torch, app, v, q, Q,
                                              "quantile")
    if keep:
        got["quantile"] = Q
    del Q
    loc = _local(v)
    first = -_sig_start(app, v) % SIG_NAN_EVERY
    loc[first::SIG_NAN_EVERY] = float("nan")
    Q = step("nanquantile", lambda: nps.nanquantile(v, q))
    if checks:
        out["nanquantile"] = _sig_quantile_check(torch, app, v, q, Q,
                                                 "nanquantile")
    if keep:
        got["nanquantile"] = Q
    del Q, v, loc, q
    _mesh_free(torch)
    # convolve/correlate of a signal by a sharded kernel; polymul; poly
    sig = _sig_vector(torch, app, cfg["signal"], SIG_SEED + 3, "real")
    ker = _sig_vector(torch, app, cfg["taps"], SIG_SEED + 4, "real")
    for op, mode in (("convolve", "full"), ("correlate", "same")):
        C = step(op, lambda op=op, mode=mode: getattr(nps, op)(
            sig, ker, mode=mode))
        if checks:
            out[op] = _sig_conv_check(torch, app, sig, ker, C, op, mode)
        if keep:
            got[op] = C
        del C
    del sig, ker
    p1 = _sig_vector(torch, app, cfg["poly"], SIG_SEED + 5, "real")
    p2 = _sig_vector(torch, app, cfg["poly"], SIG_SEED + 6, "real")
    C = step("polymul", lambda: nps.polymul(p1, p2))
    if checks:
        out["polymul"] = _sig_polymul_check(torch, app, p1, p2, C)
    if keep:
        got["polymul"] = C
    del C, p1, p2
    z = _sig_vector(torch, app, cfg["roots"], SIG_SEED + 7, "roots")
    C = step("poly", lambda: nps.poly(z))
    if checks:
        out["poly"] = _sig_poly_check(torch, app, z, C)
    if keep:
        got["poly"] = C
    del C, z
    _mesh_free(torch)
    # the n-D transform of X (drawn here where X is a function)
    X = X() if callable(X) else X
    G = step("fft2", lambda: nps.fft.fft2(X))
    if checks:
        out["fft2"] = _sig_fft2_check(torch, app, X, G)
    if keep:
        got["fft2"] = G
    del G, X
    _mesh_free(torch)
    return got


def phase_mesh_signal(torch, smi, app, X):
    """Phase 21 in the full run, on phase 15's world-1 mesh: X's first
    ``SIG_WORLD1["n"]`` rows and the vectors at ``SIG_WORLD1``'s depth,
    every step on the mesh with its checks and again on the serial backend
    (each draws its vectors from the same seeds), every result bit for bit
    equal; no kernel launched."""
    from nums_tpu_torch.core import application_manager

    t_phase = time.perf_counter()
    n = SIG_WORLD1["n"]
    mesh_app = application_manager._instance
    Xs = X[:n]
    info, out = {}, {}
    got = _sig_steps(torch, app, Xs, SIG_WORLD1,
                     _shape_step_fn(torch, info), out, keep=True)
    serial = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE)
    application_manager.set_instance(serial)
    try:
        ref = _sig_steps(torch, serial, _serial_twin(serial.backend, Xs),
                         SIG_WORLD1, lambda name, fn: fn(), {}, checks=False,
                         keep=True)
    finally:
        application_manager.set_instance(mesh_app)
    differ = _same_results(torch, got, ref)
    _sig_hold(not differ, ("mesh vs serial", differ))
    bounds = _sig_bounds(SIG_WORLD1, 1, D_FULL)
    _sig_held(torch, info, bounds, None)
    launches = {name: sum(st["launches"].get(name, 0)
                          for st in info.values()) for name, _, _ in KERNELS}
    out.update({"phase": "mesh_signal", "world": 1, "shape": [n, D_FULL],
                "config": SIG_WORLD1, "nvidia_smi": smi, "steps": info,
                "bounds": bounds, "launches": launches,
                "bitwise_vs_serial": sorted(got), "failed": SIG_FAILED,
                "seconds": time.perf_counter() - t_phase})
    del got, ref, Xs
    _mesh_free(torch)
    emit(out)
    assert not SIG_FAILED, SIG_FAILED
    assert sum(launches.values()) == 0, launches
    return out


def _sig_cards(torch, cfg):
    """--mesh-signal-only on this rank: ``_sig_steps`` at ``SIG_FULL`` on
    the (cards, 1) mesh with every check, X of 10M x 1000 fp32 drawn from
    phase 4's seed for its step; each step held to its bytes, no
    all-gather inside a torch op, no kernel, its peak below X's bytes;
    rank 0 prints the phase's line."""
    import torch.distributed as dist

    from nums_tpu_torch.core import application_manager

    world = dist.get_world_size()
    n, d = cfg["n"], cfg["d"]
    app = application_manager.create(
        device=None if DEVICE == "cuda" else DEVICE, backend="mesh",
        cluster_shape=(world, 1))
    application_manager.set_instance(app)
    say = emit if dist.get_rank() == 0 else (
        lambda obj: print(json.dumps(obj)))
    t0 = time.perf_counter()
    info, out = {}, {}
    step = _shape_step_fn(torch, info)

    def logged(name, fn):
        res = step(name, fn)
        print(json.dumps({"mesh_signal_step": name, **info[name]}),
              flush=True)
        return res

    _sig_steps(torch, app, lambda: _draw_mesh_x(torch, app, n, d), cfg,
               logged, out)
    bounds = _sig_bounds(cfg, world, d)
    _sig_held(torch, info, bounds, 4 * n * d)
    peaks = [None] * world
    dist.all_gather_object(peaks, max(st["peak_bytes"]
                                      for st in info.values()))
    launches = [None] * world
    dist.all_gather_object(launches, {
        name: sum(st["launches"].get(name, 0) for st in info.values())
        for name, _, _ in KERNELS})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines() if DEVICE == "cuda" else []
    say({"phase": "mesh_signal", "world": world, "shape": [n, d],
         "cluster_shape": [world, 1], "config": {
             k: v for k, v in cfg.items() if k in SIG_FULL}, **out,
         "steps": info, "bounds": bounds, "peak_bytes_per_card": peaks,
         "launches_per_card": launches, "nvidia_smi_per_card": smi,
         "failed": SIG_FAILED, "seconds": time.perf_counter() - t0})
    assert all(sum(c.values()) == 0 for c in launches), launches
    assert not SIG_FAILED, SIG_FAILED


def phase_mesh_signal_cards(torch, smi):
    """--mesh-signal-only: one process per visible card, as --shape-only
    spawns them, each running ``_sig_cards``; fails unless every rank
    exits 0 before ``SIG_DEADLINE_S``. Returns the number of ranks."""
    world = torch.cuda.device_count() if DEVICE == "cuda" else 4
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "mesh_logs")
    os.makedirs(out_dir, exist_ok=True)
    cfg = {**SIG_FULL, "d": D_FULL, "device": DEVICE,
           "deadline": SIG_DEADLINE_S, "out_dir": out_dir, "root": root,
           "entry": "_sig_cards"}
    emit({"phase": "mesh_signal_start", "world": world, "nvidia_smi": smi,
          "config": SIG_FULL})
    t0 = time.perf_counter()
    codes = _spawn_ranks(world, cfg)
    assert codes == [0] * world, ("mesh_signal ranks' exit codes", codes)
    emit({"phase": "mesh_signal_done", "world": world, "exit_codes": codes,
          "seconds": time.perf_counter() - t0})
    return world


KERNELS = (
    ("gram", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:139"),
    ("gram_weighted", "nums_tpu_torch/csrc/gram.cu",
     "nums_tpu/core/ops/pallas_gram.py:81"),
    ("newton_stats", "nums_tpu_torch/csrc/newton.cu",
     "nums_tpu/core/ops/pallas_newton.py:143"),
)


def kernels_line(counts, fit_counts, times, ooc, linalg_launches, higgs,
                 facade, models, mesh, mesh_ooc, masks, core, shape,
                 mesh_random, signal):
    """One entry per kernel: "launches" counts the main path (phase 4),
    "launches_per_fit" one fit (phase 6), "launches_ooc" the streamed
    steps of phase 8 (the PCA and TruncatedSVD fits among them),
    "launches_linalg" one ``ridge_regression`` of phase 9, the one entry
    point there that reaches a kernel, "launches_higgs" phase 10's gram,
    fit and two predicts; "panel_ms" is its time on one resident panel of
    phase 8, and "panel_bound_ms" that panel's bound; "higgs_ms" its time
    at phase 10's shape (8.8M x 28 for K1, x 29 for K2 and K3, K3 on X
    staged once), beside that shape's plain version and bound;
    "launches_facade" phase 12's facade path (K1: one per contraction form),
    "launches_models" phase 14's (K1: the forward of the gram's gradient),
    "launches_mesh" phase 15's main path on the mesh of this card alone,
    "launches_mesh_ooc" phase 16's streamed steps on it (the mesh branch
    of ``ooc_put``), and "mesh_panel_ms" its time on this card's rows of
    one panel there, beside that panel's bound; "launches_masks" phase
    17's gram, fit and predict on the filtered rows, "launches_mesh_core"
    phase 18's steps (K1 in ``ridge_regression``'s RᵀR and the SPD
    matrix's gram, K3 in the fits that reach it), "launches_mesh_shape"
    phase 19's steps (none: the slicing, shape and order ops reach no
    kernel), "launches_mesh_random" phase 20's (none: the random layer
    and the linear algebra on the mesh reach no kernel),
    "launches_mesh_signal" phase 21's (none: the FFTs, convolutions,
    polynomials and quantiles on the mesh reach no kernel).
    gram.cu's weighted launches ("gram_weighted") on these paths are K3's
    Hessian, and K2 proper in phase 8's pass with the Newton gate off."""
    return [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "launches_per_fit": fit_counts[name],
         "launches_ooc": ooc["launches"][name],
         "launches_linalg": linalg_launches[name],
         "max_abs_err": times[name]["max_abs_err"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms"),
         "panel_ms": ooc["panel"][name]["ms"],
         "panel_bound_ms": ooc["panel"][name]["bound_ms"],
         "launches_higgs": higgs["launches"][name],
         "higgs_max_abs_err": higgs["kernels"][name]["max_abs_err"],
         "higgs_ms": higgs["kernels"][name]["ms"],
         "higgs_plain_ms": higgs["kernels"][name]["plain_ms"],
         "higgs_bound_ms": higgs["kernels"][name]["bound_ms"],
         "launches_facade": facade["launches"][name],
         "launches_models": models["launches"][name],
         "launches_mesh": mesh["launches"][name],
         "launches_mesh_ooc": mesh_ooc["launches"][name],
         "launches_masks": masks["launches"][name],
         "launches_mesh_core": sum(st["launches"].get(name, 0)
                                   for st in core["steps"].values()),
         "launches_mesh_shape": sum(st["launches"].get(name, 0)
                                    for st in shape["steps"].values()),
         "launches_mesh_random": mesh_random["launches"][name],
         "launches_mesh_signal": signal["launches"][name],
         "mesh_panel_ms": mesh_ooc["pass_parts"]["panel_kernels_rank0"][
             name]["ms"],
         "mesh_panel_bound_ms": mesh_ooc["pass_parts"][
             "panel_kernels_rank0"][name]["bound_ms"]}
        for name, src, rep in KERNELS
    ]


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        smi = phase_device(torch)
        if "--random-only" in argv:
            import nums_tpu_torch

            phase_random(torch, smi, nums_tpu_torch.init(), None)
            return 0
        phase_build()
        if "--mesh-signal-only" in argv:
            world = phase_mesh_signal_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--mesh-random-only" in argv:
            world = phase_mesh_random_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--shape-only" in argv:
            world = phase_shape_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--mesh-core-only" in argv:
            world = phase_mesh_core_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--masks-only" in argv:
            world = phase_masks_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--mesh-only" in argv:
            world = phase_mesh_cards(torch, smi)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": world}})
            return 0
        if "--models-only" in argv:
            import nums_tpu_torch

            app = nums_tpu_torch.init()
            X, _ = draw_facade_x(torch, app)
            phase_models(torch, smi, app, X, draw_labels(torch, app, X))
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})
            return 0
        if "--facade-only" in argv:
            import nums_tpu_torch

            app = nums_tpu_torch.init()
            X, draw_seconds = draw_facade_x(torch, app)
            phase_facade(torch, smi, app, X, draw_seconds)
            torch.cuda.empty_cache()
            phase_facade_tail(torch, smi, app, X)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})
            return 0
        phase_small(torch)
        if "--kernels-only" in argv:
            return 0
        app, X, y, model, counts, ref, acc_true, draw, keep = (
            phase_main_path(torch))
        times = phase_times(torch, smi, X, y, model)
        fit_counts = phase_profile(torch, X, y)
        phase_glm_families(torch, app, X, y, ref)
        ooc = phase_ooc(torch, smi, app, X, y, model, acc_true)
        wide = phase_linalg_wide(torch, app, X)
        # Phase 9 allocates up to five times its 8.6 GB A: phase 4's 10 GB
        # X and everything fitted on it go first.
        del X, y, model, ref
        torch.cuda.empty_cache()
        linalg_launches = phase_linalg(torch, smi, app, wide)
        torch.cuda.empty_cache()
        higgs = phase_higgs(torch, smi, app)
        torch.cuda.empty_cache()
        phase_random(torch, smi, app, draw)
        torch.cuda.empty_cache()
        X, draw_seconds = draw_facade_x(torch, app)
        facade = phase_facade(torch, smi, app, X, draw_seconds)
        torch.cuda.empty_cache()
        phase_facade_tail(torch, smi, app, X)
        torch.cuda.empty_cache()
        models = phase_models(torch, smi, app, X, draw_labels(torch, app, X))
        del X
        torch.cuda.empty_cache()
        mesh, mesh_ooc, masks, core, shape, mesh_random, signal = (
            phase_mesh(torch, smi, keep))
        emit({"kernels": kernels_line(counts, fit_counts, times, ooc,
                                      linalg_launches, higgs, facade,
                                      models, mesh, mesh_ooc, masks,
                                      core, shape, mesh_random, signal)})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 - report any failed phase and exit 1
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
