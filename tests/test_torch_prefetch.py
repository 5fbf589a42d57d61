"""The port's double-buffered prefetch ingestion (twins of
tests/test_prefetch.py, on ``keystone_tpu_torch.data.prefetch``): the
background reader delivers segments in order, with the serial path's
payloads, no dropped or duplicated segment, bounded staging depth, clean
shutdown on a consumer error, reader errors and exhausted retries
re-raised consumer-side; streamed fits from a prefetched source have the
serial fits' bits (dense and COO folds).

The port stages each segment for its device on the reader thread
(``stage_segment``): page-locked host tensors for a card, owned copies on
the CPU. The ``cuda`` cases run the pinned staging and the side-stream
copy on the card, bit for bit against the serial path, and count the disk
fold's kernel launches; they skip without a card. The file imports
neither JAX nor the JAX package, so it runs on the card's machine:
``python -m pytest tests/test_torch_prefetch.py -m cuda --noconftest``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.prefetch import (
    Prefetcher,
    PrefetchStats,
    ResidentDenseSource,
    ShardSource,
    iter_segments,
)
from keystone_tpu_torch.data.shards import DiskCOOShards, DiskDenseShards
from keystone_tpu_torch.ops.learning.streaming_ls import CosineBankFeaturize
from keystone_tpu_torch.parallel import streaming


class CountingSource(ShardSource):
    """Instrumented source: records which segments loaded, and when."""

    def __init__(self, num_segments, n_true=0, delay=0.0):
        self.num_segments = num_segments
        self.n_true = n_true or num_segments * 10
        self.delay = delay
        self.loaded = []
        self.max_unconsumed = 0
        self._consumed = 0
        self._lock = threading.Lock()

    def load(self, s):
        if self.delay:
            time.sleep(self.delay)
        with self._lock:
            self.loaded.append(s)
            self.max_unconsumed = max(
                self.max_unconsumed, len(self.loaded) - self._consumed
            )
        return np.full((4, 3), s, dtype=np.float32)

    def mark_consumed(self):
        with self._lock:
            self._consumed += 1


class TestPrefetcher:
    def test_order_preserved_no_drops_no_dups(self):
        src = CountingSource(17)
        got = [(s, payload) for s, payload in Prefetcher(src, depth=3)]
        assert [s for s, _ in got] == list(range(17))
        assert sorted(src.loaded) == list(range(17))  # each loaded once
        for s, payload in got:
            assert (payload == s).all()

    def test_matches_serial_path_exactly(self):
        src = CountingSource(9)
        serial = [
            (s, p.copy())
            for s, p in iter_segments(
                CountingSource(9), prefetch_depth=0
            )
        ]
        pre = [(s, p.copy()) for s, p in iter_segments(src, prefetch_depth=2)]
        assert len(serial) == len(pre)
        for (s0, p0), (s1, p1) in zip(serial, pre):
            assert s0 == s1
            np.testing.assert_array_equal(p0, p1)

    def test_backpressure_bounds_staging_depth(self):
        # The reader may run at most depth loads ahead of consumption
        # (depth queued + 1 being handed over).
        src = CountingSource(24)
        depth = 2
        for _, _ in Prefetcher(src, depth=depth):
            src.mark_consumed()
            time.sleep(0.005)  # slow consumer: reader must wait on the queue
        assert src.max_unconsumed <= depth + 1, src.max_unconsumed

    def test_consumer_error_shuts_reader_down(self):
        src = CountingSource(1000, delay=0.001)
        with pytest.raises(RuntimeError, match="consumer boom"):
            for s, _ in Prefetcher(src, depth=2):
                if s == 3:
                    raise RuntimeError("consumer boom")
        # The generator finalizer closed the prefetcher: the reader
        # stopped long before segment 1000 and no thread leaked.
        time.sleep(0.05)
        assert len(src.loaded) < 20
        assert not any(
            t.name == "keystone-prefetch" for t in threading.enumerate()
        )

    def test_reader_error_propagates_to_consumer(self):
        class Exploding(ShardSource):
            num_segments = 5
            n_true = 50

            def load(self, s):
                if s == 2:
                    raise OSError("disk gone")
                return np.zeros(3)

        seen = []
        with pytest.raises(OSError, match="disk gone"):
            for s, _ in Prefetcher(Exploding(), depth=2):
                seen.append(s)
        assert seen == [0, 1]

    def test_prefetcher_is_single_use(self):
        # A second iteration after close would hang forever on the queue
        # (the stopped reader never posts the done sentinel) — fail loud.
        src = CountingSource(4)
        p = Prefetcher(src, depth=2)
        assert len(list(p)) == 4
        with pytest.raises(RuntimeError, match="single-use"):
            next(iter(p))

    def test_stats_account_load_time(self):
        stats = PrefetchStats()
        src = CountingSource(6, delay=0.01)
        for _ in Prefetcher(src, depth=2, stats=stats):
            pass
        assert stats.segments == 6
        assert stats.load_s >= 6 * 0.01

    def test_consumer_error_depth_gt_1_slow_reader_joins_promptly(self):
        """The depth > 1, slow-reader stop path: a consumer that raises
        while a load is mid-flight with every slot staged must still stop
        the pass promptly and release every staged payload (futures
        cancelled or drained, not leaked)."""
        src = CountingSource(1000, delay=0.02)  # slow reader
        p = Prefetcher(src, depth=3)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="consumer boom"):
            for s, _ in p:
                if s == 1:
                    time.sleep(0.12)  # let the reader fill all 3 slots
                    raise RuntimeError("consumer boom")
        join_wall = time.perf_counter() - t0
        # close() (via the generator finalizer) stopped the pass: no
        # per-pass thread exists (the pooled runtime worker persists by
        # design), the stop did not ride out the 1000-segment stream,
        # and the staged payloads were released, not leaked.
        assert not any(
            t.name == "keystone-prefetch" for t in threading.enumerate()
        )
        assert join_wall < 5.0
        assert p.staged_count == 0
        assert len(src.loaded) < 20

    def test_reader_retries_transient_errors_into_stats(self, monkeypatch):
        """Transient OSErrors on the reader thread retry with
        backoff instead of killing the pass; the recovery is visible in
        PrefetchStats (surfaced via profiling.prefetch_retry_counters)."""
        from keystone_tpu_torch.utils import profiling

        monkeypatch.setenv("KEYSTONE_RETRY_BASE_S", "0.001")

        class FlakyOnce(ShardSource):
            num_segments = 5
            n_true = 50

            def __init__(self):
                self.failed = set()

            def load(self, s):
                if s == 2 and s not in self.failed:
                    self.failed.add(s)
                    raise OSError("transient blip")
                return np.full(3, s, np.float32)

        stats = PrefetchStats()
        got = [s for s, _ in Prefetcher(FlakyOnce(), depth=2, stats=stats)]
        assert got == list(range(5))  # nothing dropped or reordered
        counters = profiling.prefetch_retry_counters(stats)
        assert counters["retries"] == 1 and counters["backoff_s"] > 0.0

    def test_shard_backed_sources_do_not_nest_retries(self, tmp_path,
                                                      monkeypatch):
        """The shard layer owns disk retries for shard-backed sources;
        the prefetcher must NOT wrap load() in a second policy, or a
        dead disk costs attempts^2 reads and compounded backoff before
        the error surfaces."""
        from keystone_tpu_torch.utils import faults

        monkeypatch.setenv("KEYSTONE_RETRY_BASE_S", "0.001")
        rng = np.random.default_rng(5)
        shards = DiskDenseShards.write(
            str(tmp_path / "d"),
            rng.normal(size=(200, 6)).astype(np.float32),
            rng.normal(size=(200, 2)).astype(np.float32),
            tile_rows=32, tiles_per_segment=2,
        )
        source = shards.as_source()
        assert source.load_retries_transients
        dead = faults.FaultPlan(
            [faults.FaultRule("shard.load", "error", p=1.0)]
        )
        with dead:
            with pytest.raises(OSError):
                for _ in Prefetcher(source, depth=2):
                    pass
        # Exactly ONE bounded retry cycle: 3 attempts at the shard
        # layer, not 3x3 through a nested prefetch-layer policy.
        assert dead.calls_seen("shard.load") == 3
        # The resume rebox (iter_segments start=) must keep the same
        # ownership — a checkpointed fit's remaining segments get the
        # identical failure cost.
        dead2 = faults.FaultPlan(
            [faults.FaultRule("shard.load", "error", p=1.0)]
        )
        with dead2:
            with pytest.raises(OSError):
                for _ in iter_segments(shards.as_source(), start=1):
                    pass
        assert dead2.calls_seen("shard.load") == 3

    def test_reader_retry_exhaustion_reraises_consumer_side(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_RETRY_BASE_S", "0.001")

        class AlwaysDown(ShardSource):
            num_segments = 4
            n_true = 40

            def load(self, s):
                if s == 1:
                    raise OSError("disk gone for good")
                return np.zeros(2)

        stats = PrefetchStats()
        seen = []
        with pytest.raises(OSError, match="disk gone for good"):
            for s, _ in Prefetcher(AlwaysDown(), depth=2, stats=stats):
                seen.append(s)
        assert seen == [0]
        assert stats.retries == 2  # 3 attempts = 2 retries, then re-raise


class TestPrefetchedFits:
    """Streamed fits from a prefetched ShardSource are bit-identical to
    the serial path (same fold programs, same order)."""

    def _dense_shards(self, tmp_path, n=733, d_in=16, k=3, tile=128, tps=2):
        rng = np.random.default_rng(7)
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32)
        shards = DiskDenseShards.write(
            str(tmp_path / "dense"), X, Y, tile_rows=tile,
            tiles_per_segment=tps,
        )
        return shards, X, Y

    def test_dense_prefetch_bitwise_equals_serial(self, tmp_path):
        shards, X, Y = self._dense_shards(tmp_path)
        rng = np.random.default_rng(8)
        d_feat, bs = 64, 16
        bank = CosineBankFeaturize(
            torch.from_numpy(rng.normal(size=(d_feat, X.shape[1])).astype(np.float32) * 0.3),
            torch.from_numpy(rng.uniform(0, 6, d_feat).astype(np.float32)),
        )

        def fit(depth):
            return streaming.streaming_bcd_fit_segments(
                shards.as_source(), bank=bank, d_feat=d_feat,
                block_size=bs, lam=1e-2, num_iter=2,
                prefetch_depth=depth,
            )

        W_on, fm_on, ym_on, loss_on = fit(2)
        W_off, fm_off, ym_off, loss_off = fit(0)
        assert torch.equal(W_on, W_off) and torch.equal(fm_on, fm_off)
        assert torch.equal(ym_on, ym_off) and torch.equal(loss_on, loss_off)

    def test_resident_source_matches_disk_source(self, tmp_path):
        # The protocol unification: the SAME fold runs over in-RAM
        # segments and memory-mapped disk segments, identically.
        shards, X, Y = self._dense_shards(tmp_path)
        rng = np.random.default_rng(9)
        d_feat, bs = 64, 16
        bank = CosineBankFeaturize(
            torch.from_numpy(rng.normal(size=(d_feat, X.shape[1])).astype(np.float32) * 0.3),
            torch.from_numpy(rng.uniform(0, 6, d_feat).astype(np.float32)),
        )
        resident = ResidentDenseSource(
            X, Y, tile_rows=shards.tile_rows,
            tiles_per_segment=shards.tiles_per_segment,
        )
        out_disk = streaming.streaming_bcd_fit_segments(
            shards.as_source(), bank=bank, d_feat=d_feat, block_size=bs,
            lam=1e-2, num_iter=2, prefetch_depth=2,
        )
        out_ram = streaming.streaming_bcd_fit_segments(
            resident, bank=bank, d_feat=d_feat, block_size=bs,
            lam=1e-2, num_iter=2, prefetch_depth=2,
        )
        assert torch.equal(out_disk[0], out_ram[0])

    def test_coo_prefetch_matches_serial_callable(self, tmp_path):
        from keystone_tpu_torch.ops.learning.lbfgs import (
            _resident_chunk_fn,
            run_lbfgs_gram_streamed,
        )

        D, K, W_ACT, CHUNK = 256, 2, 5, 512
        n = 3 * CHUNK + 101
        rng = np.random.default_rng(3)
        idx = rng.integers(0, D, size=(n, W_ACT)).astype(np.int32)
        val = rng.normal(size=(n, W_ACT)).astype(np.float32)
        y = rng.normal(size=(n, K)).astype(np.float32)
        shards = DiskCOOShards.write(
            str(tmp_path / "coo"), idx, val, y, chunk_rows=CHUNK,
            n_true=n, d=D,
        )

        W_pre, loss_pre = run_lbfgs_gram_streamed(
            _resident_chunk_fn, shards.num_chunks, D, K,
            lam=1e-2, num_iterations=15, n=n,
            segment_source=shards.as_source(2),
            prefetch_depth=2, device="cpu",
        )
        W_ser, loss_ser = run_lbfgs_gram_streamed(
            _resident_chunk_fn, shards.num_chunks, D, K,
            lam=1e-2, num_iterations=15, n=n,
            segment_source=shards.segment_source,
            max_chunks_per_dispatch=2, device="cpu",
        )
        assert torch.equal(W_pre, W_ser) and torch.equal(loss_pre, loss_ser)

    def test_function_source_requires_num_segments(self):
        with pytest.raises(ValueError, match="num_segments"):
            list(iter_segments(lambda s: s))
        got = [p for _, p in iter_segments(lambda s: s * 2, num_segments=4,
                                           prefetch_depth=0)]
        assert got == [0, 2, 4, 6]


class TestStaging:
    def test_cpu_staging_copies_read_only_maps(self, tmp_path):
        from keystone_tpu_torch.data.prefetch import stage_segment, to_device_segment

        rng = np.random.default_rng(3)
        shards = DiskDenseShards.write(
            str(tmp_path / "s"), rng.normal(size=(100, 4)).astype(np.float32),
            rng.normal(size=(100, 2)).astype(np.float32), tile_rows=32, tiles_per_segment=2,
        )
        X_seg, Y_seg, valid = shards.segment_source(0)
        assert not X_seg.flags.writeable  # a view of the read-only map
        staged = stage_segment((X_seg, Y_seg, valid), "cpu")
        X_t, Y_t, v = to_device_segment(staged, "cpu")
        assert v == valid and X_t.is_contiguous()
        X_t += 1.0  # owned memory: the map is never written through
        np.testing.assert_array_equal(shards.segment_source(0)[0], X_seg)
        assert torch.equal(Y_t, torch.from_numpy(np.array(Y_seg)))

    def test_stage_runs_on_the_reader_thread_and_is_timed(self):
        names = []

        def stage(payload):
            names.append(threading.current_thread().name)
            time.sleep(0.01)
            return payload

        stats = PrefetchStats()
        got = [p for _, p in iter_segments(CountingSource(4), prefetch_depth=2, stats=stats,
                                           stage=stage)]
        assert len(got) == 4 and all(n.startswith("keystone-io-") for n in names)
        assert stats.load_s >= 4 * 0.01


def _cuda_bank(d_in, d_feat, seed=8):
    rng = np.random.default_rng(seed)
    return CosineBankFeaturize(
        torch.from_numpy(rng.normal(size=(d_feat, d_in)).astype(np.float32) * 0.3).cuda(),
        torch.from_numpy(rng.uniform(0, 6, d_feat).astype(np.float32)).cuda(),
    )


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
class TestOnCard:
    def test_pinned_staging_and_side_stream_copy(self, tmp_path):
        from keystone_tpu_torch.data.prefetch import stage_segment, to_device_segment

        rng = np.random.default_rng(5)
        X = rng.normal(size=(1000, 64)).astype(np.float32)
        shards = DiskDenseShards.write(str(tmp_path / "p"), X, X[:, :3].copy(), tile_rows=128,
                                       tiles_per_segment=2)
        staged = stage_segment(shards.segment_source(1), "cuda")
        assert staged[0].is_pinned() and staged[1].is_pinned()
        side = torch.cuda.Stream()
        X_d, Y_d, valid = to_device_segment(staged, "cuda", side)
        torch.cuda.synchronize()
        want = torch.from_numpy(np.array(shards.segment_source(1)[0])).cuda()
        assert X_d.is_cuda and torch.equal(X_d, want) and valid == 256

    def test_dense_fold_depths_and_card_bits(self, tmp_path):
        from keystone_tpu_torch.ops import cuda_ops

        rng = np.random.default_rng(7)
        n, d_in, d_feat, k, tile = 5000, 40, 512, 3, 512
        X = rng.normal(size=(n, d_in)).astype(np.float32)
        Y = rng.normal(size=(n, k)).astype(np.float32)
        shards = DiskDenseShards.write(str(tmp_path / "d"), X, Y, tile_rows=tile,
                                       tiles_per_segment=2)
        bank = _cuda_bank(d_in, d_feat)
        outs = {}
        for depth in (2, 0):
            cuda_ops.reset_launch_counts()
            outs[depth] = streaming.streaming_bcd_fit_segments(
                shards.as_source(), bank=bank, d_feat=d_feat, block_size=128, lam=1e-2,
                num_iter=2, prefetch_depth=depth,
            )
            torch.cuda.synchronize()
            tiles = -(-n // tile)
            assert cuda_ops.launches["gram_sym_acc"] == tiles
            assert cuda_ops.launches["cosine_features"] == tiles
        for a, b in zip(outs[2], outs[0]):
            assert torch.equal(a, b)
        # The same fold from resident segments already on the card.
        resident = ResidentDenseSource(X, Y, tile_rows=tile, tiles_per_segment=2)
        again = streaming.streaming_bcd_fit_segments(
            resident, bank=bank, d_feat=d_feat, block_size=128, lam=1e-2, num_iter=2,
        )
        assert torch.equal(again[0], outs[2][0])

    def test_coo_fold_depths_on_card(self, tmp_path):
        from keystone_tpu_torch.ops import cuda_ops
        from keystone_tpu_torch.ops.learning.lbfgs import (
            _resident_chunk_fn,
            run_lbfgs_gram_streamed,
        )

        D, K, W_ACT, CHUNK = 1024, 2, 8, 2048
        n = 5 * CHUNK + 77
        rng = np.random.default_rng(3)
        idx = rng.integers(0, D, size=(n, W_ACT)).astype(np.int32)
        val = rng.normal(size=(n, W_ACT)).astype(np.float32)
        y = rng.normal(size=(n, K)).astype(np.float32)
        shards = DiskCOOShards.write(str(tmp_path / "coo"), idx, val, y, chunk_rows=CHUNK,
                                     n_true=n, d=D)
        runs = []
        for depth in (2, 0):
            cuda_ops.reset_launch_counts()
            runs.append(run_lbfgs_gram_streamed(
                _resident_chunk_fn, shards.num_chunks, D, K, lam=1e-2, num_iterations=15, n=n,
                segment_source=shards.as_source(4), prefetch_depth=depth, device="cuda",
            ))
            assert cuda_ops.launches["gram_corr_sym_acc"] == 8  # 2 segments of 4 chunks
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
