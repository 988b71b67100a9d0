"""The port's continuous-batching streaming decode on the CPU (counterpart
of ``tests/test_decode_stream.py``): ``TokenStream`` semantics, the slot
pool, ``LMDecoder.generate`` against the JAX package's (both heads, the
JAX weights and index carried over), token-exactness of interleaved vs
blocking decode (sessions joining and leaving mid-flight), one build per
(head, tag), EOS, index-epoch pins, and the AsyncRuntime's decode request
kind (admission control, deadlines, mixed traffic, a blocking
``generate`` beside a serving runtime).

On the CPU the fused decode step runs eagerly; on the card it is a CUDA
graph (``tests/test_torch_cuda_kernels.py`` holds the two against each
other)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced_model_cfg as j_reduced  # noqa: E402
from repro.core import lss as jlss  # noqa: E402
from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import LMDecoder as JLMDecoder  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.convert import (lss_index_from_numpy,  # noqa: E402
                                 transformer_params_from_numpy)
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.data.synthetic import lm_dataset  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.serve import (AsyncRuntime,  # noqa: E402
                               DeadlineExceededError, KVCachePool,
                               LMDecoder, QueueFullError, RuntimeClosedError,
                               TokenStream)

ARCH = "qwen2-0.5b"
PROMPT_LEN = 6
MAX_LEN = 24          # prompt + the longest max_new_tokens any test uses
LSS_CFG = dict(k_bits=4, n_tables=2)
TAG = f"decode[3x{MAX_LEN}]@{ARCH}-reduced"
NEAR_TIE = 1e-4       # a diverging token is allowed only at a near tie
T_OUT = 120.0


def carry_index(jindex, device="cpu"):
    t = jindex.tables
    return lss_index_from_numpy(
        np.asarray(jindex.theta), np.asarray(t.table_ids),
        np.asarray(t.n_dropped), np.asarray(jindex.w_bucketed), None,
        t.k_bits, t.n_tables, t.capacity, device=device)


@pytest.fixture(scope="module")
def lm():
    """The reduced qwen2-0.5b in both packages (JAX's weights), a JAX
    random-SimHash index over its LM head, and token rows."""
    jcfg, cfg = j_reduced(ARCH), reduced_model_cfg(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = lm_dataset(0, 64 * 33, cfg.vocab, 33)
    return jcfg, jparams, cfg, params, toks


def make_decoder(lm, jindex=None, max_streams=3, **kw):
    _, _, cfg, params, _ = lm
    dec = LMDecoder(params, cfg, LSSConfig(**LSS_CFG),
                    max_streams=max_streams, max_len=MAX_LEN, **kw)
    if jindex is not None:
        dec.engine._set_index(carry_index(jindex))
    return dec


@pytest.fixture(scope="module")
def jdec(lm):
    jcfg, jparams, _, _, _ = lm
    dec = JLMDecoder(jparams, jcfg, JLSSConfig(**LSS_CFG), impl="ref",
                     max_streams=3, max_len=MAX_LEN)
    dec.engine.fit_random(jax.random.PRNGKey(1))
    return dec


@pytest.fixture(scope="module")
def decoder(lm, jdec):
    """One decoder (and thus ONE fused step per head) shared by the
    module — itself an implicit single-build regression."""
    return make_decoder(lm, jdec.engine.index)


def seq_generate(dec, toks, budgets, head):
    return [dec.generate(toks[i:i + 1, :PROMPT_LEN], steps=budgets[i],
                         head=head, timeout=T_OUT).numpy()[0]
            for i in range(len(budgets))]


# ------------------------------------------------------------ TokenStream --

def test_token_stream_append_get_iter_result():
    st = TokenStream(0)
    st.append(5), st.append(7)
    assert len(st) == 2 and st.get(0, timeout=1.0) == 5
    assert st.get(1, timeout=1.0) == 7 and not st.done()
    st.append(9)
    st.finish("max_tokens")
    assert st.done() and st.finish_reason == "max_tokens"
    assert list(st) == [5, 7, 9]
    np.testing.assert_array_equal(st.result(timeout=1.0), [5, 7, 9])
    assert st.exception(timeout=1.0) is None
    with pytest.raises(IndexError):
        st.get(3, timeout=1.0)


def test_token_stream_fail_reraises_after_tokens():
    st = TokenStream(1)
    st.append(3)
    st.fail(RuntimeError("boom"))
    assert st.finish_reason == "error"
    assert isinstance(st.exception(timeout=1.0), RuntimeError)
    it = iter(st)
    assert next(it) == 3
    with pytest.raises(RuntimeError):
        next(it)
    with pytest.raises(RuntimeError):
        st.result(timeout=1.0)


def test_token_stream_timeouts_and_timing():
    st = TokenStream(2, t_submit=time.perf_counter())
    with pytest.raises(TimeoutError):
        st.get(0, timeout=0.01)
    with pytest.raises(TimeoutError):
        st.result(timeout=0.01)
    assert st.ttft_s() is None
    st.append(1)
    assert st.ttft_s() >= 0
    st.append(2)
    assert st.inter_token_s().shape == (1,)


# -------------------------------------------------------------- KV pool --

def test_kv_pool_alloc_free_and_validation(lm):
    cfg = lm[2]
    pool = KVCachePool(cfg, max_streams=2, max_len=8, device="cpu")
    assert pool.k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                            cfg.head_dim)
    assert pool.storage_bytes() == 2 * pool.k.numel() * 4
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1} and pool.alloc() is None
    assert pool.n_active == 2 and pool.n_free == 0
    pool.lengths[a] = 5
    pool.free(a)
    assert pool.lengths[a] == 0 and pool.n_free == 1
    assert pool.alloc() == a
    with pytest.raises(ValueError):
        KVCachePool(cfg, max_streams=0, max_len=8, device="cpu")


# ------------------------------------------------------ against the JAX --

def _margin(jparams, jcfg, jindex, head, prompt, prefix):
    """JAX's top-2 margin of the next token after ``prompt + prefix``."""
    toks = jnp.asarray(np.concatenate([prompt, prefix])[None])
    hidden, _, _ = JT.forward(jparams, toks, jcfg)
    h = hidden[:, -1].astype(jnp.float32)
    if head == "full":
        top = jax.lax.top_k(JT.logits_head(jparams, h[:, None], jcfg)[:, 0],
                            2)[0]
    else:
        top = jlss.lss_forward(h, jindex, None, 2, impl="ref").top_logits
    return float(top[0, 0] - top[0, 1])


@pytest.mark.parametrize("head", ["full", "lss"])
def test_generate_matches_jax(lm, jdec, decoder, head):
    """Three prompts at once through both packages' ``generate``: the
    tokens agree up to the first step where they differ, and there the
    JAX top-2 margin must be a near tie."""
    jcfg, jparams, _, _, toks = lm
    prompts = toks[:3, :PROMPT_LEN]
    want = np.asarray(jdec.generate(jnp.asarray(prompts), steps=10,
                                    head=head))
    got = decoder.generate(prompts, steps=10, head=head,
                           timeout=T_OUT).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    for i in range(3):
        diff = np.flatnonzero(got[i] != want[i])
        if diff.size:
            t = int(diff[0])
            m = _margin(jparams, jcfg, jdec.engine.index, head, prompts[i],
                        want[i, :t])
            assert m < NEAR_TIE, (i, t, m)


# --------------------------------------------- interleaved == blocking --

@pytest.mark.parametrize("head", ["full", "lss"])
def test_interleaved_exact_vs_sequential_generate(decoder, lm, head):
    """5 greedy sessions with STAGGERED budgets through 3 slots — sessions
    leave as their budgets run out and queued ones join the freed slots
    mid-flight — give the tokens of one-at-a-time blocking generate."""
    toks = lm[4]
    budgets = [3, 6, 9, 4, 12]
    seq = seq_generate(decoder, toks, budgets, head)
    sched = decoder.scheduler(head=head)
    streams = [sched.submit(toks[i, :PROMPT_LEN], max_new_tokens=budgets[i])
               for i in range(5)]
    sched.run(timeout=T_OUT)
    for i, st in enumerate(streams):
        assert st.finish_reason == "max_tokens"
        np.testing.assert_array_equal(st.result(timeout=1.0), seq[i],
                                      err_msg=f"session {i} head {head}")
    # the fused step shape never changed: exactly one build, ever
    assert decoder.engine.compile_counts[(head, TAG)] == 1


def test_eos_stops_stream_early_and_frees_slot(decoder, lm):
    toks = lm[4]
    ref = decoder.generate(toks[7:8, :PROMPT_LEN], steps=10, head="full",
                           timeout=T_OUT).numpy()[0]
    eos = int(ref[4])
    cut = int(np.argmax(ref == eos)) + 1     # first occurrence, inclusive
    sched = decoder.scheduler(head="full")
    streams = [sched.submit(toks[7, :PROMPT_LEN], max_new_tokens=10,
                            eos_id=eos)]
    streams += [sched.submit(toks[20 + i, :PROMPT_LEN], max_new_tokens=4)
                for i in range(3)]
    sched.run(timeout=T_OUT)
    assert streams[0].finish_reason == "eos"
    np.testing.assert_array_equal(streams[0].result(timeout=1.0), ref[:cut])
    for st in streams[1:]:
        assert st.finish_reason == "max_tokens" and len(st) == 4
    assert sched.pool.n_free == sched.max_streams


def test_one_build_across_sessions_and_generate_calls(lm, jdec):
    """The scheduler and every generate() call share ONE fused step per
    head: after the first call neither new sessions nor new generate()
    calls build again (the engine's build counts), and every LSS rank
    dispatches lss_topk (the registry's counts)."""
    toks = lm[4]
    dec = make_decoder(lm, jdec.engine.index, max_streams=2)
    registry.reset_dispatch_log()
    dec.generate(toks[:1, :PROMPT_LEN], steps=3, head="lss", timeout=T_OUT)
    for i in range(3):
        dec.generate(toks[i:i + 1, :PROMPT_LEN], steps=4, head="lss",
                     timeout=T_OUT)
    sched = dec.scheduler(head="lss")
    streams = [sched.submit(toks[i, :PROMPT_LEN], max_new_tokens=3 + i)
               for i in range(5)]
    sched.run(timeout=T_OUT)
    assert all(st.finish_reason == "max_tokens" for st in streams)
    decode_keys = [k for k in dec.engine.compile_counts
                   if isinstance(k[1], str)]
    assert decode_keys == [("lss", f"decode[2x{MAX_LEN}]@{ARCH}-reduced")]
    assert all(v == 1 for v in dec.engine.compile_counts.values()), \
        dec.engine.compile_counts
    s = sched.stats()
    counts = registry.dispatch_counts()
    # one lss_topk per fused step and per first-token rank
    assert counts[("lss_topk", "ref")] == s.n_steps + 9
    assert ("simhash_codes", "ref") not in counts


def test_generation_pins_its_index_epoch(lm, jdec):
    """A generation ranks through the epoch it started under: a refit in
    the middle neither drops that epoch nor reaches its sessions, and the
    epoch is released when the pool drains."""
    toks = lm[4]
    dec = make_decoder(lm, jdec.engine.index)
    ref = dec.generate(toks[:1, :PROMPT_LEN], steps=6, head="lss",
                       timeout=T_OUT).numpy()[0]
    eng = dec.engine
    e0 = eng.index_epoch
    sched = dec.scheduler(head="lss")
    st = sched.submit(toks[0, :PROMPT_LEN], max_new_tokens=6)
    sched.tick()                                   # admit: pins e0
    assert eng._epochs[e0].pins == 1
    eng.fit_random(torch.Generator().manual_seed(9))   # a refit: e1 serves
    assert eng.index_epoch != e0 and e0 in eng._epochs
    sched.run(timeout=T_OUT)
    np.testing.assert_array_equal(st.result(timeout=1.0), ref)
    assert e0 not in eng._epochs                   # drained -> dropped


@pytest.mark.parametrize("head", ["full", "lss"])
def test_pool_grows_between_generate_calls(lm, jdec, head):
    """``max_len=None`` sizes the pool at the first ``generate`` (64 wide
    at least).  A later call that needs more rebuilds the idle scheduler
    at the new width and drops the outgrown fused step from the engine's
    table.  The grown pool gives the tokens of a decoder built at that
    width, and a runtime-attached scheduler refuses to grow."""
    _, _, cfg, params, toks = lm

    def mk(max_len):
        dec = LMDecoder(params, cfg, LSSConfig(**LSS_CFG), max_streams=2,
                        max_len=max_len)
        dec.engine._set_index(carry_index(jdec.engine.index))
        return dec

    dec = mk(None)
    dec.generate(toks[:1, :PROMPT_LEN], steps=4, head=head, timeout=T_OUT)
    small = dec.scheduler(head)
    assert small.max_len == 64
    table = (dec.engine._steps if head == "full"
             else dec.engine._epoch_state().steps)
    assert (head, small._tag) in table
    prompt = np.concatenate([toks[1], toks[2]])[None, :60]
    got = dec.generate(prompt, steps=10, head=head, timeout=T_OUT).numpy()
    grown = dec.scheduler(head)
    assert grown is not small and grown.max_len == 70
    assert (head, small._tag) not in table and (head, grown._tag) in table
    want = mk(70).generate(prompt, steps=10, head=head,
                           timeout=T_OUT).numpy()
    np.testing.assert_array_equal(got, want)
    rt = AsyncRuntime(dec.engine, head=head, scheduler=grown, start=False)
    with pytest.raises(ValueError, match="max_len"):
        dec.generate(prompt, steps=11, head=head, timeout=T_OUT)
    rt.close(timeout=T_OUT)
    assert dec.scheduler(head) is grown


def test_session_validation(decoder, lm):
    toks = lm[4]
    sched = decoder.scheduler(head="full")
    with pytest.raises(ValueError):                # exceeds pool width
        sched.submit(toks[0, :PROMPT_LEN], max_new_tokens=MAX_LEN)
    with pytest.raises(ValueError):                # 2-D prompt
        sched.submit(toks[:2, :PROMPT_LEN], max_new_tokens=2)
    with pytest.raises(ValueError):                # empty budget
        sched.submit(toks[0, :PROMPT_LEN], max_new_tokens=0)
    rt = AsyncRuntime(decoder.engine, start=False)  # no scheduler attached
    with pytest.raises(RuntimeError, match="DecodeScheduler"):
        rt.submit_decode(toks[0, :PROMPT_LEN], max_new_tokens=2)
    rt.close()
    with pytest.raises(ValueError, match="fit_lss"):
        LMDecoder(lm[3], lm[2]).scheduler(head="lss")


# ------------------------------------------------- runtime integration --

def test_runtime_decode_matches_blocking_and_streams_tokens(decoder, lm):
    toks = lm[4]
    budgets = [4, 7, 5, 8]
    seq = seq_generate(decoder, toks, budgets, "lss")
    sched = decoder.scheduler(head="lss")
    sched.reset_stats()
    with AsyncRuntime(decoder.engine, head="lss", scheduler=sched) as rt:
        streams = [rt.submit_decode(toks[i, :PROMPT_LEN],
                                    max_new_tokens=budgets[i])
                   for i in range(4)]
        # mixed traffic: rank requests on the same engine while decoding
        futs = [rt.submit(np.zeros(lm[2].d_model, np.float32))
                for _ in range(3)]
        first = [streams[0].get(i, timeout=T_OUT)  # live, token by token
                 for i in range(budgets[0])]
        rt.drain(timeout=T_OUT)
        s = rt.stats()
    assert first == list(seq[0])
    for i, st in enumerate(streams):
        np.testing.assert_array_equal(st.result(timeout=1.0), seq[i])
    assert all(f.exception(timeout=T_OUT) is None for f in futs)
    assert s.n_decode_sessions == s.n_decode_done == 4
    assert s.n_decode_tokens == sum(budgets)
    assert s.ttft_p50_ms > 0 and s.itl_p50_ms >= 0
    assert s.ttft_p50_ms <= s.ttft_p95_ms <= s.ttft_p99_ms
    assert 0 < s.decode_slot_occupancy <= 1.0
    assert s.decode_tokens_per_s > 0
    assert s.n_completed == 3                      # the rank side
    assert sched.on_session_done is None           # detached at close


def test_generate_while_runtime_serves_same_scheduler(decoder, lm):
    """A blocking generate() racing an AsyncRuntime that owns the same
    scheduler stays token-exact (ticks serialize) and does not perturb
    the runtime's session accounting."""
    toks = lm[4]
    ref_rt = decoder.generate(toks[0:1, :PROMPT_LEN], steps=10,
                              head="full", timeout=T_OUT).numpy()[0]
    ref_gen = decoder.generate(toks[1:2, :PROMPT_LEN], steps=6,
                               head="full", timeout=T_OUT).numpy()[0]
    sched = decoder.scheduler(head="full")
    with AsyncRuntime(decoder.engine, scheduler=sched) as rt:
        st = rt.submit_decode(toks[0, :PROMPT_LEN], max_new_tokens=10)
        out = decoder.generate(toks[1:2, :PROMPT_LEN], steps=6,
                               head="full", timeout=T_OUT)
        rt.drain(timeout=T_OUT)
        s = rt.stats()
    np.testing.assert_array_equal(st.result(timeout=1.0), ref_rt)
    np.testing.assert_array_equal(out.numpy()[0], ref_gen)
    assert s.n_decode_sessions == s.n_decode_done == 1


def test_runtime_decode_deadline_shed(decoder, lm):
    toks = lm[4]
    sched = decoder.scheduler(head="full")
    rt = AsyncRuntime(decoder.engine, scheduler=sched, start=False)
    late = rt.submit_decode(toks[0, :PROMPT_LEN], max_new_tokens=4,
                            deadline_s=0.01)
    ok = rt.submit_decode(toks[1, :PROMPT_LEN], max_new_tokens=4)
    time.sleep(0.05)                               # 'late' is now late
    rt.start()
    rt.drain(timeout=T_OUT)
    s = rt.stats()
    rt.close(timeout=T_OUT)
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=5.0)
    assert len(ok.result(timeout=5.0)) == 4
    assert s.n_shed_deadline == 1 and s.n_decode_done == 2


def test_runtime_decode_queue_capacity_shed(decoder, lm):
    toks = lm[4]
    sched = decoder.scheduler(head="full")
    rt = AsyncRuntime(decoder.engine, scheduler=sched, max_queue=2,
                      policy="shed", start=False)
    streams = [rt.submit_decode(toks[i, :PROMPT_LEN], max_new_tokens=3)
               for i in range(5)]
    shed = [st for st in streams if st.done()]
    assert len(shed) == 3                          # queue bound of 2 held
    for st in shed:
        with pytest.raises(QueueFullError):
            st.result(timeout=1.0)
    assert rt.stats().n_shed_queue == 3
    rt.start()
    rt.drain(timeout=T_OUT)
    s = rt.stats()
    assert s.n_decode_sessions == 5 and s.n_decode_done == 2
    assert sum(st.finish_reason == "max_tokens" for st in streams) == 2
    rt.close(timeout=T_OUT)


def test_runtime_close_fails_pending_decode(decoder, lm):
    toks = lm[4]
    sched = decoder.scheduler(head="full")
    rt = AsyncRuntime(decoder.engine, scheduler=sched, start=False)
    st = rt.submit_decode(toks[0, :PROMPT_LEN], max_new_tokens=4)
    rt.close(timeout=T_OUT)
    with pytest.raises(RuntimeClosedError):
        st.result(timeout=5.0)
    with pytest.raises(RuntimeClosedError):
        rt.submit_decode(toks[1, :PROMPT_LEN], max_new_tokens=4) \
          .result(timeout=5.0)
    assert sched.on_session_done is None and sched.idle
