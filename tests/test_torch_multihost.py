"""Multi-process serving on the CPU (counterpart of the JAX package's
``tests/test_multihost.py``): real ``torch.distributed`` fleets over gloo,
each process with one intra-op thread and a timeout on every wait.

* Four ranks as 2 hosts x 2 (``LOCAL_WORLD_SIZE=2``) over a ``FileStore``
  at the JAX fleet test's toy geometry (m = 230 over 4 shards, the last
  one padded; int8 slabs): the hierarchical and the flat predict, the
  ``Engine._step`` seam (the leader's ``rank`` ships its batch, followers
  replay in ``follower_loop``), two leader threads at once, an aborted
  and a committed ``leader_swap_index``, and mirrored ``generate`` —
  each bit for bit the in-process oracle (every shard in one process);
  the opcode channel drops keys ``_GC_WINDOW`` sends behind.
* Where each rank's card comes from: host names and card identities
  exchanged through a ``FileStore``, and the backend they give.
* The serve launcher as two processes (``--reduced --device cpu``) in
  generate and async modes, and its refusal of ``--mode decode`` on a
  fleet before the process group starts.
"""

import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 240

_WORKER = r"""
import json, sys, threading
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.core import simhash
from repro_torch.core.lss import LSSConfig, build_index
from repro_torch.core.sharded import (make_multihost_predict,
                                      make_sharded_predict)
from repro_torch.distributed import (ServingMesh, is_distributed,
                                     process_allgather, process_count,
                                     process_index, shutdown_distributed)
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, LMDecoder
from repro_torch.serve.heads import shard_index
from repro_torch.serve.multihost import (follower_loop, init_multihost,
                                         leader_generate, stop_followers)
from repro_torch.testing import faults

store_path, rank = sys.argv[1], int(sys.argv[2])
M, D, K, BATCH = 230, 16, 6, 8
CFG = LSSConfig(k_bits=3, n_tables=2, slab_dtype="int8")
W = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (M, D)).astype(np.float32))
Q = np.random.default_rng(2).standard_normal((BATCH, D)).astype(np.float32)
THETA = simhash.init_hyperplanes(torch.Generator().manual_seed(3), D + 1,
                                 CFG.k_bits, CFG.n_tables, device="cpu")
THETA2 = simhash.init_hyperplanes(torch.Generator().manual_seed(11), D + 1,
                                  CFG.k_bits, CFG.n_tables, device="cpu")
LM_CFG = T.TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                             n_kv_heads=2, head_dim=8, d_ff=32, vocab=64,
                             dtype=torch.float32, kv_chunk=8)
LM_PARAMS = T.init_params(torch.Generator().manual_seed(5), LM_CFG,
                          device="cpu")
PROMPT = np.random.default_rng(7).integers(0, 64, (2, 4)).astype(np.int32)


def make_engine(spmd=None, mesh=None):
    eng = Engine(None, W, None, CFG, top_k=K, head="lss-sharded",
                 buckets=(BATCH,), mesh=mesh, spmd=spmd)
    eng.fit_random(torch.Generator().manual_seed(1))
    return eng


def make_decoder(spmd=None, mesh=None):
    dec = LMDecoder(LM_PARAMS, LM_CFG, LSSConfig(k_bits=3, n_tables=2),
                    max_streams=2, max_len=12, spmd=spmd)
    dec.engine.mesh = mesh
    dec.engine.fit_random(torch.Generator().manual_seed(6))
    return dec


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


# ---- the in-process oracle: every shard in this process, no group -----
local4 = ServingMesh.local(4)
w_aug = simhash.augment_neurons(W, None)
full, _, m_local = shard_index(w_aug, THETA, CFG, 4)
oracle = make_sharded_predict(local4, m_local, K,
                              with_aux=True)(torch.from_numpy(Q), full)
ref_eng = make_engine(mesh=local4)
e_ref = ref_eng.rank(Q)
ref_eng.swap_index(build_index(ref_eng._w_aug, THETA2, CFG))
s_ref = ref_eng.rank(Q)
toks_ref = make_decoder(mesh=local4).generate(PROMPT, steps=4,
                                              head="lss-sharded")

ctx = init_multihost(None, 4, rank, device="cpu",
                     store=dist.FileStore(store_path, 4))
assert ctx is not None and ctx.n_shards == 4, ctx
assert (ctx.mesh.n_hosts, ctx.mesh.ranks_per_host) == (2, 2)
assert ctx.mesh.backend == "gloo" and ctx.shard_range() == (rank, rank + 1)
assert is_distributed() and (process_index(), process_count()) == (rank, 4)
assert process_allgather(np.asarray([rank, 2 * rank])).tolist() == \
    [[r, 2 * r] for r in range(4)]
ctx.channel._GC_WINDOW = 4
report = {"rank": rank}

# ---- 1. each rank builds only its shard; both merges == the oracle ----
r0, r1 = ctx.row_range(M)
local, _, ml = shard_index(simhash.augment_neurons(W[r0:r1], None), THETA,
                           CFG, 4, shard_range=ctx.shard_range(), m_total=M)
assert ml == m_local and len(local) == 1
for make in (lambda: make_multihost_predict(ctx.mesh, ml, K, with_aux=True),
             lambda: make_sharded_predict(ctx.mesh, ml, K, with_aux=True)):
    got = make()(torch.from_numpy(Q), local)
    assert all(same(g, o) for g, o in zip(got, oracle)), (got, oracle)
report["predict"] = True

# ---- 2. the Engine._step seam ------------------------------------------
eng = make_engine(spmd=ctx)
if ctx.is_leader:
    for _ in range(2):                  # the second reuses the step
        out = eng.rank(Q)
        assert same(out.ids, e_ref.ids) and same(out.logits, e_ref.logits)
        assert same(out.sample_size, e_ref.sample_size)
    # two leader threads at once serialise on the channel
    res = {}
    t = threading.Thread(target=lambda: res.update(
        full=eng.rank(Q, head="full", record=False)))
    t.start()
    out3 = eng.rank(Q, record=False)
    t.join(timeout=120)
    assert not t.is_alive(), "concurrent full-head rank hung"
    assert same(out3.ids, e_ref.ids)
    assert tuple(res["full"].ids.shape) == (BATCH, K)
else:
    assert follower_loop(eng, ctx, max_ops=4) == 4
report["engine"] = True

# ---- 3. swaps: an abort leaves every rank on its epoch, a commit flips --
if ctx.is_leader:
    idx2 = build_index(eng._w_aug, THETA2, CFG)
    try:
        with faults.injected(faults.MULTIHOST_SWAP_COMMIT,
                             RuntimeError("crash before commit")):
            eng.swap_index(idx2)
        raise SystemExit("the aborted swap did not raise")
    except RuntimeError:
        pass
    assert eng.index_epoch == 1, eng.index_epoch
    assert same(eng.rank(Q, record=False).ids, e_ref.ids)
    assert eng.swap_index(idx2) == eng.index_epoch == 2
    out5 = eng.rank(Q, record=False)
    assert same(out5.ids, s_ref.ids) and same(out5.logits, s_ref.logits)
else:
    assert follower_loop(eng, ctx, max_ops=1) == 1     # the aborted swap
    assert eng.index_epoch == 1, eng.index_epoch
    assert follower_loop(eng, ctx, max_ops=3) == 3
    assert eng.index_epoch == 2, eng.index_epoch
report["swap"] = True

# ---- 4. mirrored decode -------------------------------------------------
dec = make_decoder(spmd=ctx)
if ctx.is_leader:
    toks = leader_generate(ctx, dec, PROMPT, steps=4, head="lss-sharded")
    assert same(toks.numpy(), toks_ref.numpy()), (toks, toks_ref)
    stop_followers(ctx)
    # the channel kept only the last _GC_WINDOW messages
    seq = ctx.channel.seq
    report["gc"] = [ctx.channel.holds(i) for i in range(1, seq + 1)]
else:
    assert follower_loop(eng, ctx, decoder=dec) == 1
report["decode"] = True
report["messages"] = ctx.channel.seq
shutdown_distributed()
assert not is_distributed() and process_count() == 1
print("REPORT " + json.dumps(report), flush=True)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    for k in ("REPRO_DIST_COORDINATOR", "REPRO_DIST_NUM_PROCESSES",
              "REPRO_DIST_PROCESS_ID", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run_fleet(cmds, env):
    """Start every command at once; wait for all (killing the fleet if
    one outlives the timeout).  Returns (exit codes, outputs)."""
    procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _report(out):
    import json
    lines = [ln for ln in out.splitlines() if ln.startswith("REPORT ")]
    assert lines, out[-3000:]
    return json.loads(lines[-1][len("REPORT "):])


def test_four_rank_fleet_matches_the_in_process_oracle(tmp_path):
    store = str(tmp_path / "store")
    rcs, outs = _run_fleet(
        [[sys.executable, "-c", _WORKER, store, str(r)] for r in range(4)],
        _env(LOCAL_WORLD_SIZE="2"))
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r}:\n{out[-4000:]}"
    reports = [_report(out) for out in outs]
    for rep in reports:
        assert rep["predict"] and rep["engine"] and rep["swap"] \
            and rep["decode"], rep
    # every follower read every message the leader sent
    assert {rep["messages"] for rep in reports} == {reports[0]["messages"]}
    gc = reports[0]["gc"]
    assert len(gc) > 4 and gc == [False] * (len(gc) - 4) + [True] * 4


@pytest.mark.parametrize("hosts,n_cards,local_rank,want", [
    (["a", "a", "b", "b"], 2, None, ([0, 1, 0, 1], "nccl")),
    (["a", "b", "a", "b"], 2, None, ([0, 0, 1, 1], "nccl")),
    (["a", "a", "a", "a"], 2, None, ([0, 1, 2, 3], "gloo")),
    (["a", "a"], 1, None, ([0, 1], "gloo")),
    (["a", "a"], 2, "1", ([1, 1], "gloo")),
])
def test_ranks_take_the_cards_of_their_machine(tmp_path, monkeypatch, hosts,
                                                n_cards, local_rank, want):
    """Without ``LOCAL_RANK`` the ranks of a machine take its cards in
    rank order (not all ``cuda:0``); the backend is NCCL only where no two
    ranks share a card.  A card's identity stands in for its UUID."""
    import datetime
    import threading

    import torch.distributed as dist
    from repro_torch import distributed as D
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    world, path = len(hosts), str(tmp_path / "store")
    timeout = datetime.timedelta(seconds=60)
    got = [None] * world

    def rank(r):
        store = dist.FileStore(path, world)
        lr = D._local_rank(store, r, world, timeout, host=hosts[r])
        card = f"{hosts[r]}:{lr % n_cards}"
        got[r] = (lr, D._backend("cuda", D._exchange(
            store, "device", r, world, card, timeout)))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert [g[0] for g in got] == want[0]
    assert {g[1] for g in got} == {want[1]}
    assert D._backend("cpu", ["x", "y"]) == "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SMALL = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
         "--train-steps", "4", "--steps", "4", "--batch", "4",
         "--head", "lss-sharded"]


def _launch(extra, n=2):
    port = _free_port()
    return _run_fleet(
        [[sys.executable, "-m", "repro_torch.launch.serve", *SMALL, *extra,
          "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
          "--process-id", str(i)] for i in range(n)], _env())


def test_serve_launcher_fleet_generate():
    rcs, (lead, follow) = _launch([])
    assert rcs == [0, 0], lead[-3000:] + follow[-3000:]
    for i, out in enumerate((lead, follow)):
        assert (f"multihost: process {i}/2 "
                f"({'leader' if i == 0 else 'follower'}), 2 vocab shards, "
                f"2 hosts x 1, backend gloo on cpu") in out
    assert "decoded (4, 4) tokens on 2 processes; head=lss-sharded" in lead
    assert "follower 1: 1 ops served" in follow


def test_serve_launcher_fleet_async_with_refresh():
    rcs, (lead, follow) = _launch(["--runtime", "async", "--qps", "0",
                                   "--refresh-interval", "0.05"])
    assert rcs == [0, 0], lead[-3000:] + follow[-3000:]
    assert "16/16 served" in lead
    assert "index refresh: swaps=" in lead and "failures=0" in lead
    assert "swaps=0 " not in lead
    assert "index refresh" not in follow       # the leader refreshes
    assert "ops served" in follow


def test_serve_launcher_refuses_decode_on_a_fleet():
    rcs, outs = _launch(["--mode", "decode"])
    assert all(rc not in (0, None) for rc in rcs), outs
    for out in outs:
        assert "--mode decode is not supported with multi-process" in out
        assert "multihost:" not in out and "[trainer]" not in out
