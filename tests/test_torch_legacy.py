"""PyTorch port, the legacy layout family held against the JAX package on
the CPU: Rel2Layout, Rel2RegLayout and Text2Layout (logits and boxes on the
same params within 1e-4; greedy, beam and regression decodes' tokens equal,
boxes within 1e-4), the five legacy losses within 1e-5, the masked-LM
sampler and `legacy_pretrain_batches` equal, and three steps of each legacy
trainer within 1e-4 relative (losses; parameters in relative norm).

Config: hidden 32, 2 layers, 2 heads, vocabulary 40, 12 classes, decodes
of 6 steps; float32.  The weights are JAX's init, randomized at scale 0.2
where logits must not tie, handed over through the weight bridge.  The
trainers run at lr 1e-3 on their flax init, where no gradient is rounding
noise (ROADMAP C: Adam steps such an element by ±lr either way), but for
the attention key biases, which a softmax ignores and which are left out
of the parameter check.  Torch takes one thread.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.models.layout import legacy as jleg
from diffusion_spacetime_attn_tpu.training import legacy_data as jdata
from diffusion_spacetime_attn_tpu.training import legacy_losses as jloss
from diffusion_spacetime_attn_tpu.training import legacy_trainer as jtr
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch.models.layout import legacy as tleg
from diffusion_spacetime_attn_tpu_torch.training import legacy_data as tdata
from diffusion_spacetime_attn_tpu_torch.training import legacy_losses as tloss
from diffusion_spacetime_attn_tpu_torch.training import legacy_trainer as ttr
from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat
from test_torch_pipeline import flat

CFG = dict(vocab_size=40, obj_id_size=12, cls_size=12, pos_size=10, shape_size=10, hidden=32,
           layers=2, heads=2, max_rel_pair=6, max_out_len=6)
JCFG, TCFG = jleg.LegacyConfig(**CFG), tleg.LegacyConfig(**CFG)
B, L, T = 3, 9, 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def rel_inputs(seed=0):
    r = np.random.RandomState(seed)
    tokens = r.randint(4, CFG["vocab_size"], (B, L))
    tokens[0, -3:] = 0                                   # padding
    tokens[1, -1:] = 0
    return dict(tokens=tokens, obj_ids=r.randint(0, CFG["obj_id_size"], (B, L)),
                segments=r.randint(0, CFG["max_rel_pair"], (B, L)),
                token_types=r.randint(0, 4, (B, L)), pad_mask=tokens != 0,
                cats=r.randint(1, CFG["cls_size"], (B, T)), pos=r.randint(1, 10, (B, T)),
                shapes=r.randint(1, 10, (B, T)), boxes=r.rand(B, T, 4).astype(np.float32))


ENC = ("tokens", "obj_ids", "segments", "token_types", "pad_mask")


def jinit(model, *args, scale=0.2, seed=0):
    """N(0, scale²) weights in the model's flax tree."""
    params = jax.eval_shape(model.init, jax.random.PRNGKey(seed), *args)["params"]
    return randomize_params(params, jax.random.PRNGKey(seed + 1), scale=scale)


@pytest.fixture(scope="module")
def rel2layout():
    x = rel_inputs()
    jm = jleg.Rel2Layout(JCFG)
    params = jinit(jm, *(jnp.asarray(x[k]) for k in ENC), x["cats"], x["pos"], x["shapes"])
    return jm, params, load_flat(tleg.Rel2Layout(TCFG), flat(params)).eval()


def test_rel2layout_logits_and_decodes_match_jax(rel2layout):
    jm, params, tm = rel2layout
    x = rel_inputs()
    want = jm.apply({"params": params}, *(jnp.asarray(x[k]) for k in ENC), x["cats"], x["pos"],
                    x["shapes"])
    with torch.no_grad():
        got = tm(*(torch.as_tensor(x[k]) for k in ENC), torch.as_tensor(x["cats"]),
                 torch.as_tensor(x["pos"]), torch.as_tensor(x["shapes"]))
    for g, w in zip(got, want):
        close(g, w)
    enc = [x[k] for k in ENC]
    jg = jleg.greedy_decode(jm, params, *(jnp.asarray(a) for a in enc))
    tg = tleg.greedy_decode(tm, *enc)
    for g, w in zip(tg, jg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jb = jleg.beam_decode(jm, params, *(jnp.asarray(a) for a in enc), beam=3)
    tb = tleg.beam_decode(tm, *enc, beam=3)
    for g, w in zip(tb[:3], jb[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    close(tb[3], jb[3])


def test_rel2reglayout_and_greedy_reg_match_jax():
    x = rel_inputs(1)
    jm = jleg.Rel2RegLayout(JCFG)
    params = jinit(jm, *(jnp.asarray(x[k]) for k in ENC), x["cats"], x["boxes"], seed=2)
    tm = load_flat(tleg.Rel2RegLayout(TCFG), flat(params)).eval()
    want = jm.apply({"params": params}, *(jnp.asarray(x[k]) for k in ENC), x["cats"], x["boxes"])
    with torch.no_grad():
        got = tm(*(torch.as_tensor(x[k]) for k in ENC), torch.as_tensor(x["cats"]),
                 torch.as_tensor(x["boxes"]))
    for g, w in zip(got, want):
        close(g, w)
    jc, jb = jleg.greedy_decode_reg(jm, params, *(jnp.asarray(x[k]) for k in ENC))
    tc, tb = tleg.greedy_decode_reg(tm, *(x[k] for k in ENC))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    close(tb, jb)


def test_text2layout_matches_jax():
    x = rel_inputs(2)
    jm = jleg.Text2Layout(JCFG, max_seq_len=12)
    params = jinit(jm, jnp.asarray(x["tokens"]), jnp.asarray(x["pad_mask"]), x["cats"], x["pos"],
                   x["shapes"], seed=4)
    tm = load_flat(tleg.Text2Layout(TCFG, max_seq_len=12), flat(params)).eval()
    want = jm.apply({"params": params}, jnp.asarray(x["tokens"]), jnp.asarray(x["pad_mask"]),
                    x["cats"], x["pos"], x["shapes"])
    with torch.no_grad():
        got = tm(torch.as_tensor(x["tokens"]), torch.as_tensor(x["pad_mask"]),
                 torch.as_tensor(x["cats"]), torch.as_tensor(x["pos"]),
                 torch.as_tensor(x["shapes"]))
    for g, w in zip(got, want):
        close(g, w)
    jg = jleg.greedy_decode(jm, params, *(jnp.asarray(x[k]) for k in ENC))
    tg = tleg.greedy_decode(tm, *(x[k] for k in ENC))
    for g, w in zip(tg, jg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["plain", "topk_kd", "only_wh_rel"])
def test_log_pdf_loss_matches_jax(case):
    r = np.random.RandomState(3)
    gmm = (r.randn(10, 60) * 0.5).astype(np.float32)
    xywh = r.rand(10, 4).astype(np.float32)
    xywh[[3, 6]] = 2.0
    kw = {"plain": {}, "topk_kd": dict(topk=2, kd=True),
          "only_wh_rel": dict(only_wh=True, rel_gt=True)}[case]
    want = jloss.log_pdf_loss(jnp.asarray(gmm), jnp.asarray(xywh), **kw)
    got = tloss.log_pdf_loss(torch.from_numpy(gmm), torch.from_numpy(xywh), **kw)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_reg_focal_xent_nll_losses_match_jax():
    r = np.random.RandomState(4)
    pred, target = r.randn(8, 4).astype(np.float32), r.rand(8, 4).astype(np.float32)
    target[5, 2] = 2.0
    for kw in (dict(pretrain=False, reduction="mean"), dict(pretrain=True), dict()):
        close(tloss.reg_loss(torch.from_numpy(pred), torch.from_numpy(target), **kw),
              jloss.reg_loss(jnp.asarray(pred), jnp.asarray(target), **kw), 1e-5)
    scores = r.randn(8, 6).astype(np.float32)
    labels = r.randint(0, 6, 8)
    labels[2] = 0
    for kw in (dict(), dict(alpha=0.25, ignore_index=0, reduction="mean")):
        close(tloss.focal_loss(torch.from_numpy(scores), torch.from_numpy(labels), **kw),
              jloss.focal_loss(jnp.asarray(scores), jnp.asarray(labels), **kw), 1e-5)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(scores), -1))
    for sm in (0.1, 0.0):
        close(tloss.xent_loss(torch.from_numpy(logp), torch.from_numpy(labels), 0, sm),
              jloss.xent_loss(jnp.asarray(logp), jnp.asarray(labels), 0, sm), 1e-5)
    close(tloss.nll_loss(torch.from_numpy(logp), torch.from_numpy(labels)),
          jloss.nll_loss(jnp.asarray(logp), jnp.asarray(labels)), 1e-5)


def test_legacy_data_matches_jax(tmp_path):
    r = np.random.RandomState(5)
    sents = [r.randint(0, 20, 11) for _ in range(7)]
    for s in sents:
        s[r.randint(1, 10)] = 2
    ids = [r.randint(0, 12, 11) for _ in range(7)]
    boxes = [r.rand(11, 4).astype(np.float32) for _ in range(7)]
    path = tmp_path / "rel.pkl"
    with open(path, "wb") as f:
        pickle.dump({"rel": sents, "id": ids, "rel_box": boxes}, f)
    for a, b in zip(tdata.load_legacy_rel_pickle(str(path)), jdata.load_legacy_rel_pickle(str(path))):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    got = list(tdata.legacy_pretrain_batches(sents, ids, boxes, 3, seed=1, epochs=2))
    want = list(jdata.legacy_pretrain_batches(sents, ids, boxes, 3, seed=1, epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))
    assert any((g[2] > 0).any() for g in got)               # some tokens masked


def _trainer_batch(kind, seed):
    x = rel_inputs(seed)
    b = {"tokens": x["tokens"], "obj_ids": x["obj_ids"], "segments": x["segments"],
         "token_types": x["token_types"]}
    if kind == "finetune":
        r = np.random.RandomState(seed + 10)
        b["labels"] = np.where(r.rand(B, L) < 0.3, x["tokens"], 0)
        b["type_labels"] = r.randint(0, 4, (B, L))
    else:
        b.update(cats=x["cats"], pos=x["pos"], shapes=x["shapes"], boxes=x["boxes"])
    return b


@pytest.mark.parametrize("kind", ["discrete", "reg", "finetune"])
def test_legacy_trainers_three_steps_match_jax(kind):
    jcls, tcls = {"discrete": (jtr.LegacyDiscreteTrainer, ttr.LegacyDiscreteTrainer),
                  "reg": (jtr.LegacyRegTrainer, ttr.LegacyRegTrainer),
                  "finetune": (jtr.LegacyFinetuneTrainer, ttr.LegacyFinetuneTrainer)}[kind]
    cfg = dict(encoder_lr=1e-3, decoder_lr=5e-4)
    jt = jcls(JCFG, jtr.LegacyTrainConfig(**cfg))
    tt = tcls(TCFG, ttr.LegacyTrainConfig(**cfg), device="cpu")
    batches = [_trainer_batch(kind, s) for s in range(3)]
    js = jt.init_state(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items()})
    ts = tt.init_state(init=flat(js.params))
    for b in batches:
        js, jm = jt.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tt.train_step(ts, b)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-3), k
    assert ts.step == 3
    want = flat(js.params)
    got = {k: v.detach().numpy() for k, v in ts.params.state_dict().items()}
    from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge
    ref = {k: v.numpy() for k, v in bridge(want, ts.params).items()}
    for k in ref:
        if k.endswith("key.bias"):      # softmax ignores it: its gradient is rounding noise
            continue
        err = np.linalg.norm(got[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-12)
        assert err <= 1e-4, (k, err)
    groups = {g["name"]: g["lr"] for g in ts.opt_state.param_groups}
    assert groups == {"encoder": 1e-3, "decoder": 5e-4}
