"""The port's KV tiers (``dynamo_tpu_torch/blocks/``) and the runner's page
I/O on the CPU, held against the JAX package (``tests/test_blocks.py`` is the
JAX side's own).

The tier, storage and manager cases run on both packages' classes; the page
payloads (bf16 and fp8 caches, GQA and MLA) are bitwise the JAX runner's,
through an unsigned-integer view; the engine onboards evicted prefixes from
G2 and G3, synchronously and from a background fetch, with the JAX engine's
greedy tokens and per-tier page counts."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import blocks as jblocks
from dynamo_tpu.blocks import storage as jstorage
from dynamo_tpu.engine.core import EngineConfig as JEngineConfig, EngineCore as JEngineCore
from dynamo_tpu.engine.runner import ModelRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu_torch import blocks as tblocks
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.blocks import storage as tstorage
from dynamo_tpu_torch.bridge import params_from_jax
from dynamo_tpu_torch.engine.core import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.runner import TorchModelRunner
from dynamo_tpu_torch.models.config import PRESETS
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions

PAGE = 4
PACKAGES = {"jax": (jblocks, jstorage), "torch": (tblocks, tstorage)}
_JPARAMS: dict = {}


def jparams_for(preset):
    if preset not in _JPARAMS:
        _JPARAMS[preset] = jllama.init_params(JPRESETS[preset], 0)
    return _JPARAMS[preset]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def payload(i):
    k = np.full((2, 4, 32), i, np.uint16)
    return k, k + 1


# -- tiers, storage, manager: both packages ---------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tier_eviction_order_lru_and_priority(pkg):
    blocks, storage = PACKAGES[pkg]
    evicted = []
    pool = blocks.TierPool("t", storage.HostStorage(), 2, on_evict=lambda h, p: evicted.append(h))
    pool.put(1, payload(1))
    pool.put(2, payload(2))
    assert pool.get(1) is not None  # 2 becomes the LRU
    pool.put(3, payload(3))
    assert evicted == [2] and 2 not in pool and 1 in pool and 3 in pool
    prio = blocks.TierPool("p", storage.HostStorage(), 2)
    prio.put(1, payload(1), priority=5)
    prio.put(2, payload(2), priority=0)
    prio.put(3, payload(3), priority=5)
    assert 2 not in prio and len(prio) == 2  # low priority first, though more recent
    st = pool.stats()
    assert (st.capacity, st.used, st.hits, st.evictions) == (2, 2, 1, 1)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_null_and_disk_storage(pkg, tmp_path):
    blocks, storage = PACKAGES[pkg]
    pool = blocks.TierPool("t", storage.NullStorage(), 4)
    pool.put(1, payload(1))
    assert 1 in pool and pool.get(1) is None and 1 not in pool  # payload lost by design
    assert pool.stats().misses == 1
    disk = storage.DiskStorage(tmp_path / "g3")
    disk.write(7, payload(7))
    k, v = disk.read(7)
    assert k.dtype == np.uint16 and np.array_equal(k, payload(7)[0]) and np.array_equal(v, payload(7)[1])
    disk.delete(7)
    assert disk.read(7) is None


def _manager_trace(pkg, tmp_path):
    """A G2 of 2 blocks over a G3 of 8: offloads, cascades, probes, fetches
    and onboards, as a trace of what each step returned."""
    blocks, _ = PACKAGES[pkg]
    writes = []
    mgr = blocks.KvBlockManager(
        blocks.BlockManagerConfig(g2_capacity_blocks=2, g3_capacity_blocks=8, g3_path=tmp_path / pkg),
        read_page=lambda pid: payload(pid), write_page=lambda pid, k, v: writes.append(("one", pid)),
        write_pages=lambda pids, ks, vs: writes.append(("batch", list(pids))),
    )
    trace = []
    mgr.offload_batch([(10 + i, i) for i in range(5)])  # 5 blocks: 3 cascade into G3
    trace.append(("g2", sorted(h for h in range(10, 16) if h in mgr.g2)))
    trace.append(("g3", sorted(h for h in range(10, 16) if h in mgr.g3)))
    trace.append(("probe", mgr.probe_prefix([10, 11, 12, 13, 14, 99], 0), mgr.probe_prefix([10, 11, 99, 12], 0)))
    got, tiers = mgr.fetch_prefix_tiered([10, 11, 12, 13, 14], 0, 5)
    trace.append(("fetch", [int(k[0, 0, 0]) for k, _ in got], tiers))
    mgr.onboard([7, 8], got[:2])
    mgr.onboard([9], got[2:3])
    trace.append(("writes", writes))
    stats = mgr.stats()
    trace.append(("stats", stats["offloaded"], stats["onboarded"], stats["g2"], stats["g3"]))
    trace.append(("clear", mgr.clear()))
    return trace


def test_manager_cascade_probe_fetch_and_onboard_equal_jax(tmp_path):
    want = _manager_trace("jax", tmp_path)
    got = _manager_trace("torch", tmp_path)
    assert got == want
    assert ("writes", [("batch", [7, 8]), ("one", 9)]) in got  # N pages: one batched write


def test_g4_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="g4_capacity_blocks"):
        tblocks.KvBlockManager(tblocks.BlockManagerConfig(g4_capacity_blocks=4), read_page=None, write_page=None)


# -- page I/O on the runner --------------------------------------------------

CACHES = {"bf16": (torch.bfloat16, jnp.bfloat16, np.uint16), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, np.uint8)}


def _runners(preset, cache, num_pages=16):
    """A port runner and a JAX runner whose caches hold the same seeded bytes."""
    tdt, jdt, udt = CACHES[cache]
    cfg = PRESETS[preset]
    runner = TorchModelRunner(cfg, params_from_jax(_numpy_tree(jparams_for(preset)), device="cpu"),
                              num_pages=num_pages, page_size=PAGE, max_batch_size=4, cache_dtype=tdt, device="cpu")
    jrunner = ModelRunner(JPRESETS[preset], jparams_for(preset), num_pages=num_pages, page_size=PAGE,
                          max_batch_size=4, attn_impl="reference", cache_dtype=jdt)
    rng = np.random.default_rng(7)
    for name in ("k_cache", "v_cache"):
        tcache = getattr(runner, name)
        bits = rng.integers(0, np.iinfo(udt).max + 1, size=tcache.shape, dtype=udt)
        # No NaN patterns: XLA rewrites NaN payloads to its canonical NaN.
        bits[torch.from_numpy(bits.view(np.dtype(f"i{bits.itemsize}"))).view(tdt).float().isnan().numpy()] = 0
        tcache.copy_(torch.from_numpy(bits.view(np.dtype(f"i{bits.itemsize}"))).view(tdt))
        setattr(jrunner, name, jnp.asarray(bits.view(jdt)))
    return runner, jrunner, udt


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
@pytest.mark.parametrize("cache", ["bf16", "fp8"])
def test_page_round_trip_is_bitwise(preset, cache):
    """read_pages -> write_pages to other pages -> read again: the same bytes,
    as the cache dtype's unsigned-integer view (MLA: latent and rope widths)."""
    runner, _, udt = _runners(preset, cache)
    src, dst = [1, 3, 5], [9, 10, 12]
    first = runner.read_pages(src)
    assert all(k.dtype == udt and v.dtype == udt for k, v in first)
    assert first[0][0].shape == tuple(runner.k_cache[:, 0].shape)
    assert first[0][1].shape == tuple(runner.v_cache[:, 0].shape)
    runner.write_pages(dst, [k for k, _ in first], [v for _, v in first])
    again = runner.read_pages_async(dst)
    assert again.num_pages == 3
    for (k0, v0), (k1, v1) in zip(first, again.wait()):
        assert np.array_equal(k0, k1) and np.array_equal(v0, v1)
    for p, q in zip(src, dst):  # the cache itself, byte for byte
        assert torch.equal(runner.k_cache[:, p].view(torch.uint8), runner.k_cache[:, q].view(torch.uint8))
    k, v = runner.read_page(dst[0])
    runner.write_page(2, k, v)
    assert np.array_equal(runner.read_page(2)[0], first[0][0])


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-mla"])
@pytest.mark.parametrize("cache", ["bf16", "fp8"])
def test_payloads_equal_the_jax_runners(preset, cache):
    """The same cache bytes read by both runners give the same payloads; a
    JAX payload written into the port lands as the bytes the JAX runner
    writes."""
    runner, jrunner, udt = _runners(preset, cache)
    pages = [2, 6, 7]
    want = jrunner.read_pages(pages)
    got = runner.read_pages(pages)
    for (jk, jv), (tk, tv) in zip(want, got):
        assert np.array_equal(np.asarray(jk).view(udt), tk) and np.array_equal(np.asarray(jv).view(udt), tv)
    jrunner.write_pages([11, 13, 14], [k for k, _ in want], [v for _, v in want])
    runner.write_pages([11, 13, 14], [np.asarray(k).view(udt) for k, _ in want],
                       [np.asarray(v).view(udt) for _, v in want])
    for name in ("k_cache", "v_cache"):
        jbytes = np.asarray(getattr(jrunner, name)).view(udt)
        tbytes = getattr(runner, name).view(torch.uint8).numpy().view(udt).reshape(jbytes.shape)
        assert np.array_equal(jbytes[:, 1:], tbytes[:, 1:])  # page 0 takes the padding writes


# -- the engine with tiers ---------------------------------------------------


def _tier_cores(tmp_path, tag, engine_kw=None, **bm_kw):
    """The port's and the JAX engine's cores on test-tiny's seeded weights,
    a pool of 7 pages (6 usable) and tiers of ``bm_kw``."""
    cfg_kw = dict(num_pages=7, page_size=PAGE, max_batch_size=4, max_prefill_tokens=256, max_seq_len=128,
                  **(engine_kw or {}))
    jrunner = ModelRunner(JPRESETS["test-tiny"], jparams_for("test-tiny"), num_pages=7, page_size=PAGE,
                          max_batch_size=4, prefill_bucket=16, attn_impl="reference")
    jbm = jblocks.KvBlockManager(jblocks.BlockManagerConfig(g3_path=tmp_path / f"j{tag}", **bm_kw),
                                 read_page=jrunner.read_page, write_page=jrunner.write_page,
                                 write_pages=jrunner.write_pages)
    runner = TorchModelRunner(PRESETS["test-tiny"], params_from_jax(_numpy_tree(jparams_for("test-tiny")),
                                                                    device="cpu"),
                              num_pages=7, page_size=PAGE, max_batch_size=4, prefill_bucket=16, device="cpu")
    bm = tblocks.KvBlockManager(tblocks.BlockManagerConfig(g3_path=tmp_path / f"t{tag}", **bm_kw),
                                read_page=runner.read_page, write_page=runner.write_page,
                                write_pages=runner.write_pages)
    return (JEngineCore(jrunner, JEngineConfig(**cfg_kw), block_manager=jbm), jbm,
            EngineCore(runner, EngineConfig(**cfg_kw), block_manager=bm), bm)


def _evict_and_return(core, req, stop, samp):
    """Serve prompt A, then B and C to push A out of the 6-page pool, then A
    again: every request's greedy tokens, and A's second sequence."""
    def greedy(prompt, n):
        return req(token_ids=prompt, sampling=samp(temperature=0.0), stop=stop(max_tokens=n))

    outs, pa = [], list(range(1, 13))  # 12 tokens = 3 pages
    for prompt in (pa, [50 + i for i in range(12)], [80 + i for i in range(12)], pa):
        seq = core.add_request(greedy(prompt, 3))
        toks = []
        while core.has_work:
            for s, out in core.step():
                if s is seq:
                    toks.extend(out.token_ids)
        outs.append(toks)
    return outs, seq


@pytest.mark.parametrize("mode", ["g2", "g3", "g2_async", "g3_async"])
def test_onboarded_tokens_and_page_counts_equal_jax(tmp_path, mode):
    """A prefix evicted from the card's pages comes back from G2 (or, with a
    one-block G2, from G3), synchronously or through a background fetch:
    greedy tokens, per-tier page counts and the manager's offload and
    onboard counts all equal the JAX engine's."""
    bm_kw = dict(g2_capacity_blocks=16) if mode.startswith("g2") else dict(g2_capacity_blocks=1,
                                                                           g3_capacity_blocks=16)
    engine_kw = dict(async_onboard=True, chunk_prefill_tokens=8) if mode.endswith("async") else None
    jcore, jbm, core, bm = _tier_cores(tmp_path, mode, engine_kw, **bm_kw)
    want, jseq = _evict_and_return(jcore, JRequest, JStop, JSampling)
    got, seq = _evict_and_return(core, PreprocessedRequest, StopConditions, SamplingOptions)
    assert got == want and got[0] == got[3]
    tier = mode[:2]
    assert core.onboard_page_counts == jcore.onboard_page_counts and core.onboard_page_counts.get(tier, 0) >= 2
    assert (bm.offloaded, bm.onboarded) == (jbm.offloaded, jbm.onboarded) and bm.onboarded >= 2
    assert seq.num_cached_at_start == jseq.num_cached_at_start >= 2 * PAGE
    assert core.onboard_shortfall_pages == jcore.onboard_shortfall_pages == 0
    if mode.endswith("async"):
        assert core.onboard_sessions == jcore.onboard_sessions >= 1 and not core._onboards
        assert core.onboard_wait_count >= 1 and len(core.drain_onboard_waits()) >= 1
        assert core.drain_onboard_waits() == []
        assert (core.onboard_overlap_steps, core.onboard_stall_steps) == (jcore.onboard_overlap_steps,
                                                                          jcore.onboard_stall_steps)
    assert core.allocator.stats().active_pages == 0


def test_probe_fetch_race_recomputes(tmp_path):
    """Blocks lost between the probe and the background fetch (a metadata-only
    G2) recompute: tokens exact, the shortfall counted, as in the JAX engine."""
    jcore, _, core, _ = _tier_cores(tmp_path, "race", dict(async_onboard=True, chunk_prefill_tokens=8),
                                    g2_capacity_blocks=16, null_storage=True)
    want, _ = _evict_and_return(jcore, JRequest, JStop, JSampling)
    got, seq = _evict_and_return(core, PreprocessedRequest, StopConditions, SamplingOptions)
    assert got == want and got[0] == got[3]
    assert core.onboard_sessions >= 1 and core.onboard_shortfall_pages == jcore.onboard_shortfall_pages >= 1
    assert seq.status.value == "finished" and seq.onboard_pending == 0


def test_overlapped_engine_offloads_and_onboards(tmp_path):
    """The overlapped pipeline with tiers: the same tokens and page counts as
    the synchronous engine (offloads are read between steps while a step may
    be in flight)."""
    _, _, sync, sync_bm = _tier_cores(tmp_path, "s", g2_capacity_blocks=16)
    _, _, over, over_bm = _tier_cores(tmp_path, "o", dict(overlap=True), g2_capacity_blocks=16)
    want, _ = _evict_and_return(sync, PreprocessedRequest, StopConditions, SamplingOptions)
    got, _ = _evict_and_return(over, PreprocessedRequest, StopConditions, SamplingOptions)
    assert got == want
    assert over.onboard_page_counts == sync.onboard_page_counts and over.onboard_page_counts["g2"] >= 2
    assert over_bm.offloaded == sync_bm.offloaded and over.overlap_step_counts["overlapped"] > 0


def test_service_flushes_offloads_after_routing_each_step(tmp_path):
    """The service writes committed pages through after it routed a step's
    outputs (``dynamo_tpu/engine/service.py``): no step starts with pages
    pending, and the tokens, offloads and onboards are the engine's own."""
    from dynamo_tpu_torch.engine.service import TorchEngineService
    from dynamo_tpu_torch.runtime.engine import Context

    _, _, sync, sync_bm = _tier_cores(tmp_path, "sync", g2_capacity_blocks=16)
    _, _, core, bm = _tier_cores(tmp_path, "svc", g2_capacity_blocks=16)
    want, _ = _evict_and_return(sync, PreprocessedRequest, StopConditions, SamplingOptions)
    step, pending_at_step = core.step, []

    def counted_step():
        pending_at_step.append(len(core.pending_offloads))
        return step()

    core.step = counted_step

    async def serve():
        svc = TorchEngineService(core)
        try:
            outs = []
            for prompt in (list(range(1, 13)), [50 + i for i in range(12)], [80 + i for i in range(12)],
                           list(range(1, 13))):
                req = PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                          stop=StopConditions(max_tokens=3))
                outs.append([t async for o in svc.generate(req, Context()) for t in o["token_ids"]])
            return outs
        finally:
            await svc.close()

    got = asyncio.run(serve())
    assert core.defer_offloads and got == want
    assert pending_at_step and not any(pending_at_step) and not core.pending_offloads
    assert bm.offloaded == sync_bm.offloaded > 0 and core.onboard_page_counts == sync.onboard_page_counts


# -- launcher ----------------------------------------------------------------


def test_launcher_tier_flags_and_refusals(monkeypatch, capsys):
    seen = {}

    async def fake_amain(args, **kw):
        seen.update(g2=args.g2_blocks, g3=args.g3_blocks, env=launch._engine_env())

    monkeypatch.setattr(launch, "_amain", fake_amain)
    monkeypatch.setenv("DYN_ASYNC_ONBOARD", "1")
    launch.main(["--g2-blocks", "64", "--g3-blocks", "128", "--platform", "cpu"])
    assert (seen["g2"], seen["g3"]) == (64, 128) and seen["env"]["async_onboard"] is True
    with pytest.raises(SystemExit):
        launch.main(["--g4-blocks", "8", "--platform", "cpu"])
    assert "not supported by dynamo_tpu_torch yet: --g4-blocks 8" in capsys.readouterr().err
    # The SLO plane's flags, once refused here, reach the engine config; the
    # cache-aware one also turns on background onboarding, as in the JAX build.
    monkeypatch.delenv("DYN_ASYNC_ONBOARD")
    for flag, fields in (("DYN_SLO_SCHED", dict(slo_sched=True, cache_aware=False, async_onboard=False)),
                         ("DYN_CACHE_AWARE", dict(slo_sched=False, cache_aware=True, async_onboard=True))):
        with monkeypatch.context() as m:
            m.setenv(flag, "1")
            env = launch._engine_env()
            assert {k: env.get(k, False) for k in fields} == fields, flag


def test_run_local_builds_a_tier_manager_per_worker(monkeypatch, tmp_path):
    """--g2-blocks/--g3-blocks reach every worker as a block manager with a G3
    directory of its own under the temporary directory; a served request's
    committed pages are written through to G2."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    monkeypatch.setenv("DYNAMO_WARM_CONSTRAINTS", "0")

    async def main():
        handles = await launch.run_local("test-tiny", port=0, num_workers=2, device="cpu", num_pages=64,
                                         g2_blocks=8, g3_blocks=8)
        try:
            bms = [s.core.block_manager for s in handles["services"]]
            req = PreprocessedRequest(token_ids=list(range(1, 20)), sampling=SamplingOptions(temperature=0.0),
                                      stop=StopConditions(max_tokens=4))
            from dynamo_tpu_torch.runtime.engine import Context

            outs = [o async for o in handles["services"][0].generate(req, Context())]
            for _ in range(200):  # the service lands the step's page reads once it goes idle
                if bms[0].offloaded:
                    break
                await asyncio.sleep(0.01)
            return bms, outs
        finally:
            await launch.shutdown(handles)

    bms, outs = asyncio.run(main())
    assert outs[-1]["finish_reason"] is not None
    assert [str(b.config.g3_path) for b in bms] == [str(tmp_path / f"dynamo_tpu_torch_g3_w{i}") for i in (0, 1)]
    assert bms[0].offloaded >= 1 and bms[0].g2.stats().capacity == 8 and bms[0].g3.stats().capacity == 8
