"""The port's durable sessions against the JAX package's, on the CPU.

- ``SessionStore``: a manifest written by either package loads in the
  other, byte for byte the same file; the same publish, torn publish,
  corruption, chain drift, model mismatch and ``kv.session_resume`` chaos
  give the same returns and the same typed finding kinds; both packages
  give the tiny GPT-2 the same ``model_identity``.
- ``benchmarks/bench_session.py``'s three legs on the paged batcher with a
  host tier of 2 blocks over a disk tier of 6 (block 4): a first turn,
  ``pause_session`` (pin and publish), churn that pushes the pinned chain
  off the device, then the resume through the promotion stream, pipelined
  (3 slots of 2-block chunks) and serial (one whole-tail chunk), and the
  crash leg (a fresh batcher sharing only the store). Every leg's tokens
  equal the uninterrupted two-turn baseline's and the JAX package's; the
  pinned chain's residency before the resume, the promotions, the pin
  drops and the clean audits equal too. Both packages' promotions complete
  at submit (tests/test_torch_kv_tier.py's ``SyncLoader``), so each counter
  is a function of the schedule; the port's own ``AsyncLoader`` then runs
  the pipelined leg, whose tokens must not change.
- The gateway: ``Gateway(session_store=)`` over two tiered paged replicas
  under the affinity policy, on tests/test_torch_gateway.py's shared fake
  clock, tick for tick against the JAX gateway: a session's turn,
  ``pause_session``, the holding replica killed by chaos, the resume on
  the survivor from the manifest, ``release_session(delete_manifest=True)``
  and a resume from the caller's tokens (``session.resume_fallbacks``);
  the typed errors of a pause or resume with nothing to go on.

The runs use tests/test_torch_gpt2_serving.py's tiny GPT-2 and paged
geometry (2 slots of 8 blocks of 4, 15 pages, 8-token chunks), so that the
JAX package compiles those ops once for these files in a process; every
JAX batcher run is in one test.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import session_store as j_store
from paddle_tpu_torch.inference import session_store as p_store

from test_torch_gateway import JAX as GW_JAX
from test_torch_gateway import PORT as GW_PORT
from test_torch_gateway import _error, _run
from test_torch_gpt2_serving import _margin_guard
from test_torch_kv_tier import (JAX, PORT, SyncLoader,  # noqa: F401
                                _disarmed, models, port_model)

BLOCK_BYTES = 2 * 2 * 4 * 4 * 16 * 4   # layers x K/V x heads x rows x D x f32
SESSION = dict(max_batch=2, s_max=32, block_size=4, n_pages=15,
               prefill_chunk=8, compile=False, policy="ondemand",
               prefix_cache=True)
NEW = 6


# -- the manifest store -------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_cross_load_byte_for_byte(tmp_path, writer):
    toks = list(range(40))
    stores = {"port": p_store, "jax": j_store}
    paths = {}
    for name, mod in stores.items():
        s = mod.SessionStore(str(tmp_path / name))
        m = mod.SessionManifest(session_id="alpha/1 weird", token_ids=toks,
                                block_size=16, model="GPT2:deadbeef",
                                last_activity=1234.5)
        assert s.publish(m)
        paths[name] = s.path_for("alpha/1 weird")
    assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"])
    assert open(paths["port"], "rb").read() == open(paths["jax"],
                                                    "rb").read()
    reader = stores["jax" if writer == "port" else "port"]
    got = reader.SessionStore(str(tmp_path / writer)).load(
        "alpha/1 weird", expect_model="GPT2:deadbeef")
    assert got.token_ids == toks and got.block_size == 16
    assert got.chain == stores[writer].SessionManifest(
        session_id="x", token_ids=toks, block_size=16).chain
    assert got.covered_tokens == 32 and got.last_activity == 1234.5


def _store_script(side, root):
    """Publishes, tears, corrupts and resolves manifests on one package's
    store; returns the returns and the finding kinds."""
    mod = p_store if not side.jax else j_store
    store = mod.SessionStore(root)
    seen = []

    def man(n, model=""):
        return mod.SessionManifest(session_id="s", token_ids=list(range(n)),
                                   block_size=16, model=model,
                                   last_activity=1.0)

    def load(**kw):
        m = store.load("s", **kw)
        seen.append([None if m is None else m.token_ids,
                     [f.kind for f in store.drain_findings()]])

    side.chaos.arm_scenario(
        "seed=0; kv.session_publish:torn_write:offset=25,count=1")
    seen.append([store.publish(man(32)), os.path.exists(
        store.path_for("s") + ".tmp")])
    load()                                       # only debris: torn
    seen.append(store.publish(man(32)))          # heals
    side.chaos.arm_scenario(
        "seed=0; kv.session_publish:torn_write:offset=9,count=1")
    seen.append(store.publish(man(48)))          # torn: v1 stays
    side.chaos.disarm()
    load()
    assert store.publish(man(48, "GPT2:cafe0000"))
    path = store.path_for("s")
    sound = open(path, "rb").read()
    doc = json.loads(sound)
    doc["tokens"][5] ^= 1                        # document checksum
    open(path, "wb").write(json.dumps(doc, sort_keys=True).encode())
    load()
    doc = json.loads(sound)
    doc["blocks"][1]["h"] = "0" * 16             # resealed: hash drift
    body = {k: v for k, v in doc.items() if k != "crc"}
    doc["crc"] = zlib.crc32(
        json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF
    open(path, "wb").write(json.dumps(doc, sort_keys=True).encode())
    load()
    doc = json.loads(sound)
    doc["blocks"][0]["crc"] ^= 1                 # resealed: entry crc
    body = {k: v for k, v in doc.items() if k != "crc"}
    doc["crc"] = zlib.crc32(
        json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF
    open(path, "wb").write(json.dumps(doc, sort_keys=True).encode())
    load()
    open(path, "wb").write(sound[:40])           # truncated: unreadable
    load()
    open(path, "wb").write(sound)
    load(expect_model="GPT2:00000001")           # model mismatch
    side.chaos.arm_scenario("seed=0; kv.session_resume:transient_error:"
                            "count=1")
    load(expect_model="GPT2:cafe0000")           # resume fault
    load(expect_model="GPT2:cafe0000")           # then sound
    seen.append([store.sessions(), store.delete("s"), store.delete("s")])
    load()                                       # missing
    return seen


def test_store_findings_match_the_jax_package(tmp_path):
    got = _store_script(PORT, str(tmp_path / "port"))
    ref = _store_script(JAX, str(tmp_path / "jax"))
    assert got == ref
    kinds = [k for rec in ref if isinstance(rec, list) and len(rec) == 2
             and isinstance(rec[1], list) for k in rec[1]]
    for kind in ("torn_manifest", "checksum_mismatch", "hash_drift",
                 "entry_checksum_mismatch", "unreadable", "model_mismatch",
                 "resume_fault", "missing"):
        assert kind in kinds, kind


# -- bench_session's legs -----------------------------------------------------

def _workload():
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, 128, (16,)).astype(np.int64)   # 4 blocks
    cont = rng.randint(0, 128, (3,)).astype(np.int64)
    churn = [rng.randint(0, 128, (15,)).astype(np.int64) for _ in range(10)]
    return prompt, cont, churn


def _batcher(side, models, root, tiers=True, slots=3, chunk=2):
    model = models[0] if side.jax else models[1]
    kw = dict(SESSION)
    if tiers:
        kw.update(host_kv_gib=2 * BLOCK_BYTES * 1.05 / 2 ** 30,
                  disk_kv_dir=os.path.join(root, "kv_disk"),
                  disk_kv_gib=6 * BLOCK_BYTES * 1.05 / 2 ** 30,
                  promo_slots=slots, promo_chunk_blocks=chunk,
                  session_store=os.path.join(root, "sessions"))
    b = side.serving.PagedContinuousBatcher(model, **kw)
    if side.jax:
        _margin_guard(b)
    return b


def _turn(b, prompt):
    rid = b.submit(np.asarray(prompt, np.int64), NEW)
    return b.run_until_done(max_steps=20000)[rid]


def _leg(side, models, root, slots, chunk, loader="sync"):
    """First turn, pause, churn, resume: bench_session's
    _pause_churn_resume."""
    prompt, cont, churn = _workload()
    b = _batcher(side, models, root, slots=slots, chunk=chunk)
    if loader == "sync":
        b._promoter.close()
        b._promoter = SyncLoader(side.prefetch)
    try:
        out1 = _turn(b, prompt)
        published = b.pause_session("conv", out1)
        for p in churn:
            b.submit(p, 4)
        b.run_until_done(max_steps=20000)
        pinned = b._session_pins["conv"]
        residency = [n.residency for n in pinned]
        toks = b.resume_session("conv")
        out2 = _turn(b, np.concatenate([toks, cont]))
        b.audit_pages()
        st = b.prefix_cache.stats()
        return {"out1": out1.tolist(), "out2": out2.tolist(),
                "published": published, "residency": residency,
                "resumed_tokens": toks.tolist(),
                "stats": {k: st[k] for k in (
                    "promotions", "session_pin_drops", "demotions",
                    "promotion_failures", "session_pinned_nodes",
                    "host_nodes", "disk_nodes")},
                "pin_gauge": b._session_gauge().value}
    finally:
        b.close()


def session_legs(side, models, root):
    prompt, cont, _ = _workload()
    base = _batcher(side, models, root, tiers=False)
    try:
        out1 = _turn(base, prompt)
        out2 = _turn(base, np.concatenate([out1, cont]))
    finally:
        base.close()
    legs = {"baseline": [out1.tolist(), out2.tolist()]}
    for name, (slots, chunk) in (("pipelined", (3, 2)),
                                 ("serial", (1, None))):
        legs[name] = _leg(side, models, os.path.join(root, name), slots,
                          chunk)
    crash = _batcher(side, models, os.path.join(root, "pipelined"))
    try:
        toks = crash.resume_session("conv")
        legs["crash"] = [toks.tolist(),
                         _turn(crash, np.concatenate([toks, cont])).tolist()]
        crash.audit_pages()
    finally:
        crash.close()
    return legs


def test_pipelined_leg_on_the_async_loader(port_model, tmp_path):
    """The port's own worker threads: the tokens of the uninterrupted
    baseline (the loader that completes at submit gives the JAX package's,
    below)."""
    models = (None, port_model)
    prompt, cont, _ = _workload()
    with torch.no_grad():
        base = _batcher(PORT, models, str(tmp_path), tiers=False)
        base1 = _turn(base, prompt)
        base2 = _turn(base, np.concatenate([base1, cont]))
        leg = _leg(PORT, models, str(tmp_path / "leg"), 3, 2,
                   loader="async")
    assert leg["out1"] == base1.tolist() and leg["out2"] == base2.tolist()
    assert leg["stats"]["promotions"] > 0


# -- the gateway --------------------------------------------------------------

def gateway_session_drill(run, side, clock, models, root):
    """Pause a session, kill the replica holding it, resume on the survivor
    from the manifest, release it, then resume from the caller's tokens."""
    tiered = PORT if not side.jax else JAX
    store = os.path.join(root, "sessions")
    gw = side.gw.Gateway(policy="affinity", session_store=store)
    for name in ("r0", "r1"):
        b = _batcher(tiered, models, os.path.join(root, name))
        b._promoter.close()
        b._promoter = SyncLoader(tiered.prefetch)
        gw.add_replica(name, b)
    fallbacks = side.metrics.get_registry().counter(
        "session.resume_fallbacks", "")
    fb0 = fallbacks.value
    prompt, cont, churn = _workload()
    gid = gw.submit(prompt, NEW, session_id="conv")
    run.until_done(gw)
    run.results(gw, [gid])
    run.note(gw.pause_session("conv"), dict(gw._session_last_replica))
    victim = gw._session_last_replica["conv"]
    vb = gw.pool.get(victim).batcher
    for p in churn[:6]:
        vb.submit(p, 4)
    vb.run_until_done(max_steps=20000)
    run.note([n.residency for n in vb._session_pins["conv"]])
    side.chaos.arm_scenario(f"seed=0; gateway.step.{victim}:"
                            f"transient_error:count=1")
    doomed = gw.submit(prompt, 4)
    run.until_done(gw)
    side.chaos.disarm()
    run.note([r.alive for r in gw.pool.replicas()])
    gid2 = gw.resume_session("conv", new_tokens=cont, max_new_tokens=NEW)
    run.until_done(gw)
    run.results(gw, [doomed, gid2])
    gw.release_session("conv", delete_manifest=True)
    run.note(gw.session_store.sessions(), dict(gw._session_tokens),
             fallbacks.value - fb0)
    gid3 = gw.resume_session("conv", new_tokens=cont[:1], max_new_tokens=2,
                             fallback_tokens=prompt)
    run.until_done(gw)
    run.results(gw, [gid3])
    run.note(fallbacks.value - fb0,
             [f.kind for f in gw.session_store.drain_findings()],
             {r.name: [r.batcher.audit_pages(),
                       r.batcher.prefix_cache.stats()["promotions"]]
              for r in gw.pool.replicas() if r.alive})
    run.error(lambda: gw.pause_session("nobody"))
    run.error(lambda: gw.resume_session("nobody"))
    for r in gw.pool.replicas():
        r.batcher.close()


def test_sessions_match_the_jax_package(models, tmp_path):
    """The model identity, bench_session's legs and the gateway drill, in
    one test: the JAX package compiles the geometry's ops once in a
    process, and a test runner that spreads tests over worker processes
    would pay that in each worker a test landed on."""
    jm, pm = models
    assert (p_store.model_identity(pm) == j_store.model_identity(jm)
            == "GPT2ForCausalLM:" + j_store.model_identity(jm).split(":")[1])
    with paddle.no_grad():
        ref = session_legs(JAX, models, str(tmp_path / "jax legs"))
    with torch.no_grad():
        got = session_legs(PORT, models, str(tmp_path / "port legs"))
    assert got == ref
    base1, base2 = got["baseline"]
    for name in ("pipelined", "serial"):
        leg = got[name]
        assert leg["out1"] == base1 and leg["out2"] == base2, name
        assert leg["published"] is True
        assert "device" not in leg["residency"]          # off the card
        assert leg["stats"]["promotions"] > 0
        assert leg["stats"]["session_pin_drops"] == 0
    assert got["crash"] == [base1, base2]

    with torch.no_grad():
        got = _run(gateway_session_drill, GW_PORT, models,
                   str(tmp_path / "port"))
    with paddle.no_grad():
        ref = _run(gateway_session_drill, GW_JAX, models,
                   str(tmp_path / "jax"))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"gateway record {i} differs"
    assert isinstance(GW_PORT.gw.Gateway(
        session_store=str(tmp_path / "s")).session_store,
        p_store.SessionStore)
