"""deepseek-v3-671b on the port: multi-head latent attention
(``repro_torch.models.mla``), the MoE's shared expert, multi-token
prediction, the MLA stack's latent cache and ``convert`` against the
reference's ``repro.models`` on the reference's ``reduced`` widths (2
layers, d_model 256, 4 heads, 4 experts top-2 beside 1 shared, MLA ranks
32 and 48, head dims nope 32, rope 16, v 32), from the reference's own
parameters (``convert.flat_from_tree``) and inputs from a numpy seed.

Float32 bounds: the modules (``mla_attention``, the absorbed
``mla_decode`` from a cache with empty slots and a window, ``moe`` with
its shared expert; one model and C = 2 stacked) within 1e-5 of the
largest reference value; the loss, its cross-entropies and the aux loss
within 1e-5 relative; the gradient within 1e-4 of each leaf's largest
entry; prefill, 3 decode steps from the reference's cache and the cache
within 1e-5 of each entry's largest value.  bfloat16 (float32 norms and
router): the loss within 2e-2 relative, serving logits and latent within
2e-2 of the largest.  One int round at C = 2 on the reference's uplink
noise (``RoundNoise``): every parameter within a code step, 99.9 % within
1e-5 (ROADMAP C4's bound).  Checkpoints and converted caches byte for
byte.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.config.base import apply_overrides as japply
from repro.models import build_model as jbuild_model
from repro.models import mla as jmla
from repro.models import mlp as jmlp
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.models import build_model
from repro_torch.models import mla as tmla
from repro_torch.models import mlp as tmlp

ARCH = "deepseek-v3-671b"
F32 = ("model.dtype=float32",)
B, SEQ, STEPS = 2, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(overrides=F32):
    return (japply(jconfigs.reduced(jconfigs.get_config(ARCH)), overrides),
            apply_overrides(tconfigs.reduced(tconfigs.get_config(ARCH)),
                            overrides))


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jp)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _near(got, want, tol, what=""):
    """Every entry within ``tol`` of ``want``'s largest magnitude."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _model(overrides=F32, seed=0):
    jcfg, tcfg = _configs(overrides)
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    flat = convert.flat_from_tree(_tree(jp), dtype=None, device="cpu")
    return jcfg, tcfg, jmodel, model, jp, flat


def _sub_params(jp, path):
    """The reference's subtree at ``path`` (layer 0 of the stack) and the
    same leaves as torch tensors."""
    node = jp
    for p in path:
        node = node[p]
    node = jax.tree_util.tree_map(lambda x: x[0], node)
    t = {k: torch.from_numpy(np.array(v, np.float32))
         for k, v in convert.tree_paths(_tree(node)).items()}
    return node, t


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_layout_is_the_reference_tree(reduce):
    """Paths, shapes and dtypes in ``tree_leaves`` order: the MLA leaves
    with q_norm and kv_norm float32, the shared expert under
    "moe/shared/", the MTP leaves after "head"; D at 1 of 61 layers is
    the card's cut (24,970,704,896)."""
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    if reduce:
        j, t = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    layout = build_model(t).param_shapes
    shapes = jax.eval_shape(jbuild_model(j).init, jax.random.PRNGKey(0))
    want = convert.tree_paths(shapes)
    assert list(layout) == list(want)
    for k, v in want.items():
        assert layout[k] == tuple(v.shape), k
        assert str(layout.dtypes[k]).removeprefix("torch.") == str(v.dtype), k
    keys = list(layout)
    assert keys.index("head") < keys.index("mtp/block/mla/kv_norm")
    assert layout.dtypes["blocks/mla/q_norm"] == torch.float32
    assert "blocks/moe/shared/w_gate" in layout
    if not reduce:
        one = build_model(apply_overrides(t, ("model.n_layers=1",)))
        assert one.num_params == 24_970_704_896
        assert layout["blocks/moe/shared/w_down"] == (61, 2048, 7168)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
def test_mla_attention_matches(window):
    """Full-sequence MLA, one model and C = 2 stacked: the output and the
    latent cache entries (B, S, r + d_rope)."""
    jcfg, tcfg, _, _, jp, _ = _model()
    jparams, tparams = _sub_params(jp, ("blocks", "mla"))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SEQ, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (B, SEQ))
    jout, jcache = jmla.mla_attention(jparams, jnp.asarray(x),
                                      jnp.asarray(pos), jcfg.model,
                                      window=window)
    out, cache = tmla.mla_attention(tparams, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), tcfg.model,
                                    window=window)
    assert cache.shape == (B, SEQ, tmla.latent_width(tcfg.model)) == (B, SEQ, 48)
    _near(out, jout, 1e-5, "out")
    _near(cache, jcache, 1e-5, "cache")
    # stacked: cohort 1's leaves scaled, its x another draw
    x2 = rng.standard_normal((B, SEQ, 256)).astype(np.float32)
    jp2 = jax.tree_util.tree_map(lambda w: w * 1.1, jparams)
    st = {k: torch.stack([v, v * 1.1]) for k, v in tparams.items()}
    sout, scache = tmla.mla_attention(
        st, torch.from_numpy(np.stack([x, x2])),
        torch.from_numpy(pos.copy()), tcfg.model, window=window)
    jout2, jcache2 = jmla.mla_attention(jp2, jnp.asarray(x2),
                                        jnp.asarray(pos), jcfg.model,
                                        window=window)
    _near(sout[0], jout, 1e-5, "stacked out 0")
    _near(sout[1], jout2, 1e-5, "stacked out 1")
    _near(scache[1], jcache2, 1e-5, "stacked cache 1")


@pytest.mark.parametrize("window", [0, 5])
def test_mla_absorbed_decode_matches(window):
    """The absorbed one-token decode in float32 from a cache of random
    entries, three slots empty (kv_pos −1): the output and the cache
    with the token's entry written at its slot, in place."""
    jcfg, tcfg, _, _, jp, _ = _model()
    jparams, tparams = _sub_params(jp, ("blocks", "mla"))
    rng = np.random.default_rng(2)
    Cc, width = 12, tmla.latent_width(tcfg.model)
    cache = rng.standard_normal((B, Cc, width)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(Cc, dtype=np.int32), (B, Cc)).copy()
    kv_pos[:, 9:] = -1
    x = rng.standard_normal((B, 1, 256)).astype(np.float32)
    pos = np.full((B, 1), 9, np.int32)
    slot = np.full((B,), 9, np.int32)
    jout, jcache, jkv = jmla.mla_decode(
        jparams, jnp.asarray(x), jnp.asarray(pos), jcfg.model,
        cache=jnp.asarray(cache), kv_pos=jnp.asarray(kv_pos),
        write_slot=jnp.asarray(slot), window=window)
    tcache = torch.from_numpy(cache.copy())
    out = tmla.mla_decode(tparams, torch.from_numpy(x),
                          torch.from_numpy(pos), tcfg.model, cache=tcache,
                          kv_pos=torch.from_numpy(kv_pos),
                          write_slot=torch.tensor([9]), window=window)
    _near(out, jout, 1e-5, "decode out")
    _near(tcache, jcache, 1e-5, "decode cache")
    assert np.array_equal(np.asarray(jkv)[:, 9], pos[:, 0])


def test_shared_experts_match():
    """``moe`` with deepseek's shared expert (``mlp(shared, x)`` on the
    grouped tokens): the output and the load-balance loss, one model and
    C = 2 stacked."""
    jcfg, tcfg, _, _, jp, _ = _model()
    jparams, tparams = _sub_params(jp, ("blocks", "moe"))
    assert set(k for k in tparams if k.startswith("shared/")) == {
        "shared/w_gate", "shared/w_up", "shared/w_down"}
    assert tparams["shared/w_up"].shape == (256, 128)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, SEQ, 256)).astype(np.float32)
    jout, jaux = jmlp.moe(jparams, jnp.asarray(x), jcfg.model)
    out, aux = tmlp.moe(tparams, torch.from_numpy(x), tcfg.model)
    _near(out, jout, 1e-5, "moe out")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # without the shared expert the output moves: the shared term counts
    routed = {k: v for k, v in tparams.items() if not k.startswith("shared/")}
    bare, _ = tmlp.moe(routed, torch.from_numpy(x), tcfg.model)
    assert (bare - out).abs().max() > 1e-3
    st = {k: torch.stack([v, v]) for k, v in tparams.items()}
    sout, saux = tmlp.moe(st, torch.from_numpy(np.stack([x, x[::-1].copy()])),
                          tcfg.model)
    _near(sout[0], jout, 1e-5, "stacked moe")
    np.testing.assert_allclose(float(saux[0]), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the LM: loss with MTP, gradient, stacked
# ---------------------------------------------------------------------------

def _batch(vocab, seed=0, n=B):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (n, SEQ)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


def test_loss_and_gradient_match_in_float32():
    """The total (ce + aux + 0.3·mtp_ce) and each term within 1e-5
    relative; the gradient of every leaf within 1e-4 of its largest entry
    (the embedding takes gradient from the input, the MTP's label
    embedding and nothing else; the MTP block's own aux loss is
    discarded, as the reference's)."""
    jcfg, tcfg, jmodel, model, jp, flat = _model()
    batch = _batch(tcfg.model.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jp, jb)
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, model.param_shapes).items()}
    loss, m = model.loss(live, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert set(m) == {"ce", "aux", "mtp_ce"} == set(jm)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    total = float(jm["ce"]) + float(jm["aux"]) + 0.3 * float(jm["mtp_ce"])
    np.testing.assert_allclose(float(jl), total, rtol=1e-6)
    want = convert.tree_paths(_tree(jg))
    for k, v in live.items():
        _near(v.grad, want[k], 1e-4, k)
    assert float(live["mtp/block/mla/w_uq"].grad.abs().max()) > 0


def test_loss_stacked_is_one_loss_per_cohort():
    """C = 2 cohorts stacked (cohort 1's leaves scaled, its batch another
    draw) give each cohort :meth:`loss`'s total, the MTP term in it."""
    _, tcfg, _, model, _, flat = _model()
    leaves = convert.unflatten_params(flat, model.param_shapes)
    scaled = {k: v * 1.05 for k, v in leaves.items()}
    b0, b1 = _batch(tcfg.model.vocab_size, 0), _batch(tcfg.model.vocab_size, 1)
    total, acc = model.loss_stacked(
        {k: torch.stack([leaves[k], scaled[k]]) for k in leaves},
        {k: torch.from_numpy(np.stack([b0[k], b1[k]])) for k in b0})
    for c, (p, b) in enumerate(((leaves, b0), (scaled, b1))):
        want, _ = model.loss(p, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(total[c]), float(want), rtol=1e-5)
    assert acc.shape == (2,)


def test_loss_in_bfloat16_within_its_bound():
    """bfloat16 weights with float32 norms, router and MLA norm scales:
    the loss and each term within 2e-2 relative."""
    jcfg, tcfg, jmodel, model, jp, flat = _model(())
    assert model.param_shapes.buffer_dtypes == (torch.float32, torch.bfloat16)
    batch = _batch(tcfg.model.vocab_size)
    jl, jm = jmodel.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = model.loss(convert.unflatten_params(flat, model.param_shapes),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)
    np.testing.assert_allclose(float(tm["mtp_ce"]), float(jm["mtp_ce"]),
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# serving: the latent cache
# ---------------------------------------------------------------------------

#: (overrides, max_len, tolerance)
SERVE_CASES = {
    "f32": (F32, 0, 1e-5),
    "f32_max_len": (F32, SEQ + 8, 1e-5),
    "f32_window": (F32 + ("model.attention_window=16",), 0, 1e-5),
    "bf16_max_len": ((), SEQ + 8, 2e-2),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_prefill_and_decode_match_reference(case):
    """Prefill's last logits and latent cache (L, B, C, r + d_rope), then
    3 decode steps from the reference's cache carried over
    (``convert.cache_from_reference``): logits and the cache after each
    within the case's bound of their largest value; kv_pos and length
    equal."""
    overrides, max_len, tol = SERVE_CASES[case]
    jcfg, tcfg, jmodel, model, jp, flat = _model(overrides)
    params = convert.unflatten_params(flat, model.param_shapes)
    rng = np.random.default_rng(4)
    vocab = tcfg.model.vocab_size
    toks = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), max_len=max_len)
    logits, cache = model.prefill(params, torch.from_numpy(toks),
                                  max_len=max_len)
    C = 16 if "window" in case else max(max_len, SEQ)
    assert set(cache) == {"latent", "kv_pos", "length"}
    assert cache["latent"].shape == (2, B, C, 48)
    assert cache["latent"].dtype == model.dtype

    def check(logits, jlogits, cache, jcache, what):
        _near(logits, jlogits, tol, f"{what} logits")
        got = convert.cache_to_reference(cache)
        _near(got["layers"], jcache["layers"], tol, f"{what} latent")
        assert np.array_equal(got["kv_pos"], np.asarray(jcache["kv_pos"]))
        assert got["length"] == int(jcache["length"])

    check(logits, jlogits, cache, jcache, "prefill")
    cache = convert.cache_from_reference(_tree(jcache), model.dtype,
                                         device="cpu")
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(STEPS):
        tok = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(tok))
        assert logits.shape == (B, 1, vocab)
        check(logits, jlogits, cache, jcache, f"decode {step}")
    assert int(cache["length"]) == SEQ + STEPS


def test_decode_matches_teacher_forced():
    """The absorbed decode on the port alone against its own full
    sequence: MLA over 32 positions, then the cache of positions 0..19
    and positions 20..31 decoded one at a time give the full pass's
    output at each position and its cache entries, within 1e-5 of their
    largest value.  (Module level: the whole model's MoE routes a group
    of all its tokens, so a shorter prompt drops other picks.)"""
    _, tcfg, _, _, jp, _ = _model()
    _, params = _sub_params(jp, ("blocks", "mla"))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, SEQ, 256)).astype(np.float32))
    pos = torch.arange(SEQ, dtype=torch.int32).expand(B, SEQ)
    full, entries = tmla.mla_attention(params, x, pos, tcfg.model)
    cache = torch.zeros_like(entries)
    cache[:, :20] = entries[:, :20]
    kv_pos = torch.where(pos < 20, pos, -1)
    for t in range(20, SEQ):
        out = tmla.mla_decode(params, x[:, t:t + 1], pos[:, t:t + 1],
                              tcfg.model, cache=cache, kv_pos=kv_pos,
                              write_slot=torch.tensor([t]))
        kv_pos = kv_pos.index_copy(1, torch.tensor([t]), pos[:, t:t + 1])
        _near(out[:, 0], full[:, t].numpy(), 1e-5, f"position {t}")
    _near(cache, entries.numpy(), 1e-5, "cache")


def test_cache_conversions_round_trip():
    """The reference's latent cache into the port's and back is byte for
    byte its float32 arrays; the port's cache there and back is
    ``torch.equal``."""
    jcfg, tcfg, jmodel, model, jp, flat = _model()
    toks = jnp.asarray(_batch(tcfg.model.vocab_size)["tokens"])
    _, jcache = jmodel.prefill(jp, toks, max_len=SEQ + 4)
    jc = _tree(jcache)
    tc = convert.cache_from_reference(jc, torch.float32, device="cpu")
    assert set(tc) == {"latent", "kv_pos", "length"}
    back = convert.cache_to_reference(tc)
    assert back["layers"].tobytes() == np.asarray(jc["layers"], np.float32).tobytes()
    assert back["kv_pos"].tobytes() == np.asarray(jc["kv_pos"]).tobytes()
    again = convert.cache_from_reference(back, torch.float32, device="cpu")
    assert all(torch.equal(tc[k], again[k]) for k in tc)


# ---------------------------------------------------------------------------
# the round and the checkpoint
# ---------------------------------------------------------------------------

C, I, GB, LR = 2, 2, 8, 0.5


def test_cohort_round_matches_the_reference():
    """Reduced float32 deepseek-v3 (MLA, shared expert, MTP) through one
    int round at C = 2 ("pod"), I = 2, lr 0.5, both cohorts kept, on the
    reference's parameters and uplink noise: every parameter within a
    code step (1/128), 99.9 % within 1e-5, the loss within 1e-4
    relative."""
    from repro.core import aggregation as jagg

    over = F32 + (f"fl.local_iters={I}", f"fl.learning_rate={LR}",
                  f"train.global_batch={GB}", f"train.seq_len={SEQ}")
    jcfg, tcfg, jmodel, model, jp, flat = _model(over, seed=1)
    assert tcfg.fl.cohort_axes == ("pod",)
    batch = _batch(tcfg.model.vocab_size, 6, GB)
    micro = {k: jnp.asarray(v.reshape(C, I, GB // C // I, SEQ))
             for k, v in batch.items()}
    plan = jagg.make_wire_plan("int", jcfg.quant, ("pod",), (C,))

    def one(mb, key):
        def step(p, b):
            (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
            return jax.tree_util.tree_map(
                lambda w, g: w - LR * g.astype(w.dtype), p, g), loss
        p_local, losses = jax.lax.scan(step, jp, mb)
        delta = jax.tree_util.tree_map(
            lambda a, b: (a - b).astype(jnp.float32), p_local, jp)
        agg_d = jagg.aggregate(plan, delta, jnp.float32(1.0 / C),
                               jnp.float32(1.0), key)
        new = jax.tree_util.tree_map(lambda w, d: w + d.astype(w.dtype),
                                     jp, agg_d)
        leaves = jax.tree_util.tree_leaves(delta)
        u = jagg._flat_noise(leaves, jax.random.split(key, len(leaves)))
        return new, jax.lax.pmean(losses.mean(), "pod"), u

    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jnew, jloss, u = jax.jit(jax.vmap(one, axis_name="pod"))(micro, keys)
    jnew = jax.tree_util.tree_map(lambda x: x[0], jnew)
    fn = make_fl_round(model, tcfg, (C,), collective="int", device="cpu")
    new, m = fn(flat, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=RoundNoise(None, torch.from_numpy(np.array(u)),
                                 torch.ones(C)))
    got = new.numpy()
    want = convert.flat_from_tree(_tree(jnew), device="cpu").numpy()
    assert np.abs(want - flat.numpy()).max() > 1 / 128
    diff = np.abs(got - want)
    assert diff.max() <= 1 / 128 + 1e-7, diff.max()
    assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
    np.testing.assert_allclose(float(m["loss"]), float(jloss[0]), rtol=1e-4)


def test_checkpoint_is_the_references_file(tmp_path):
    """The mixed bfloat16/float32 parameters (MLA norms, router, MTP
    leaves) saved by the port are byte for byte the reference's file, and
    each package restores the other's bit for bit."""
    _, _, _, model, jp, flat = _model(())
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jp)
    tckpt.save_params(str(tmp_path / "t"), 1, flat, model.param_shapes)
    assert ((tmp_path / "t" / "ckpt_1.msgpack").read_bytes()
            == (tmp_path / "j" / "ckpt_1.msgpack").read_bytes())
    got = tckpt.restore_params(str(tmp_path / "j"),
                               model.param_shapes.empty(device="cpu"),
                               model.param_shapes)
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    moved = tuple(b + 1 for b in flat)
    tckpt.save_params(str(tmp_path / "t"), 2, moved, model.param_shapes)
    back = convert.flat_from_tree(
        _tree(jckpt.restore_checkpoint(str(tmp_path / "t"), jp)), dtype=None,
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, moved))
