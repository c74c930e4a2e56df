"""PyTorch port, the layout trainer held against the JAX package on the CPU:
`training/losses.py` (hinge, GMM-NLL, their sum), `training/iou.py`,
`training/datasets.py` (every loader and augmentation, and the batches:
equal arrays for the same RandomState), `training/layout_trainer.py` (three
optimizer steps of a 2-layer predictor, a non-finite step skipped as
optax's `apply_if_finite` skips it, `eval_step`'s metrics, save -> restore),
and the entry points `scripts/train_layout.py` (its run dir read back by
`utils/loader.load_layout_predictor`) and `scripts/bench_train.py --what
layout`.  JAX's params come in through the bridge (`layout_state_dict`).

Tolerances, float32: losses and eval metrics 1e-5; the parameters after
three Adam steps 1e-4 (absolute and relative).  The key biases of the
attention are left out of that check: a softmax over keys does not move
when every key shifts alike, so their gradient is rounding noise, and
Adam's first steps are ±lr wherever |g| ≫ eps, in either direction per
package (ROADMAP C, "Adam on a gradient that is rounding noise").  Torch
takes one thread.
"""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.config import LayoutTrainConfig as JLayoutTrainConfig
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor as jcreate
from diffusion_spacetime_attn_tpu.training import datasets as jdata
from diffusion_spacetime_attn_tpu.training import iou as jiou
from diffusion_spacetime_attn_tpu.training import layout_trainer as jtrainer
from diffusion_spacetime_attn_tpu.training import losses as jlosses
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jtokenizer
from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig, LayoutTrainConfig
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.scripts import bench_train, train_layout
from diffusion_spacetime_attn_tpu_torch.training import datasets as tdata
from diffusion_spacetime_attn_tpu_torch.training import iou as tiou
from diffusion_spacetime_attn_tpu_torch.training import layout_trainer as ttrainer
from diffusion_spacetime_attn_tpu_torch.training import losses as tlosses
from diffusion_spacetime_attn_tpu_torch.utils import loader
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_roberta_tokenizer
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

TINY = dict(vocab_size=50265, hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140,
            max_len=16)
TRAIN = dict(batch_size=8, encoder_max_lr=1e-3, head_max_lr=3e-3, warmup_steps=2, hold_steps=2,
             decay_steps=100)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _random_batch(seed=0, B=3, L=10, R=4, O=3):
    r = np.random.RandomState(seed)
    return jlosses.LayoutBatch(
        tokens=r.randint(3, 100, (B, L)).astype(np.int32),
        object_pos=(r.rand(B, L) > 0.5).astype(np.float32),
        rel_idx=r.randint(0, L, (B, R, 2)).astype(np.int32),
        rel_type=r.randint(0, 4, (B, R)).astype(np.int32),
        rel_valid=(r.rand(B, R) > 0.3).astype(np.float32),
        abs_idx=r.randint(0, L, (B, O)).astype(np.int32),
        abs_xy=r.rand(B, O, 2).astype(np.float32),
        abs_valid=(r.rand(B, O) > 0.3).astype(np.float32))


def test_losses_match_jax():
    batch = _random_batch()
    gmm = np.random.RandomState(1).randn(3, 10, 30).astype(np.float32) * 0.5
    tb, tg = tlosses.LayoutBatch(*batch).to("cpu"), torch.from_numpy(gmm)
    close(tlosses.hinge_relation_loss(tg, tb, 0.3), jlosses.hinge_relation_loss(gmm, batch, 0.3))
    close(tlosses.gmm_nll_loss(tg, tb), jlosses.gmm_nll_loss(gmm, batch))
    t_total, t_parts = tlosses.layout_total_loss(tg, tb, 0.25, 0.2)
    j_total, j_parts = jlosses.layout_total_loss(jnp.asarray(gmm), batch, 0.25, 0.2)
    close(t_total, j_total)
    assert set(t_parts) == set(j_parts)
    for k in j_parts:
        close(t_parts[k], j_parts[k])
    assert tlosses.REL_TO_ID == jlosses.REL_TO_ID and tlosses.REL_NAMES == jlosses.REL_NAMES


def test_iou_matches_jax():
    r = np.random.RandomState(2)
    sta = {"x_mean": 0.5, "x_std": 0.2, "y_mean": 0.4, "y_std": 0.1, "w_mean": 0.3,
           "w_std": 0.1, "h_mean": 0.2, "h_std": 0.05}
    for red in ("sum", "mean"):
        for is_std in (False, True):
            pred = r.rand(12, 4) * 0.5 + 0.2
            tgt = pred + r.randn(12, 4) * 0.05
            tgt[5, 0] = 2.0                                 # a sentinel row
            j = jiou.IOUCalculator(red, sta_dict=sta).val_iou(pred, tgt, is_std)
            t = tiou.IOUCalculator(red, sta_dict=sta).val_iou(pred, tgt, is_std)
            assert t == j
    far = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float64)
    assert tiou.pairwise_iou_sum(far, far[::-1]) == jiou.pairwise_iou_sum(far, far[::-1]) == 0.0


def _fields(ex):
    return [[np.asarray(w).item() if isinstance(w, np.generic) else w for w in v]
            if isinstance(v, list) else v for v in dataclasses.astuple(ex)]


def _same_examples(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert json.dumps(_fields(a), default=str) == json.dumps(_fields(b), default=str)


def _to(cls, ex):
    return cls(**dataclasses.asdict(ex))


def test_dataset_functions_match_jax(tmp_path):
    # synthetic corpus and batches from one RandomState
    t_ex = tdata.synthetic_examples(20, np.random.RandomState(0))
    j_ex = jdata.synthetic_examples(20, np.random.RandomState(0))
    _same_examples(t_ex, j_ex)
    tt, jt = make_roberta_tokenizer(), jtokenizer()
    tb = list(tdata.batches(t_ex, tt, 6, np.random.RandomState(1), max_len=16, epochs=2))
    jb = list(jdata.batches(j_ex, jt, 6, np.random.RandomState(1), max_len=16, epochs=2))
    assert len(tb) == len(jb) == 6
    for a, b in zip(tb, jb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    # gpt-3.pkl rows: [caption, words, obj_word_indices, [[i, j, rel]], phrases]
    rows = [["a dog left of a cat", ["a ", "dog", "left", "of", "a", " cat"], [1, 5],
             [[1, 5, "left of"]], ["dog", "cat"]],
            ["the cup above the lamp", ["the", "cup", "above", "the", "lamp"], [1, 4],
             [[1, 4, "above"], [4, 1, "below"]], []]]
    pkl = tmp_path / "gpt-3.pkl"
    pkl.write_bytes(pickle.dumps(rows))
    t_g, j_g = tdata.load_gpt3_examples(str(pkl)), jdata.load_gpt3_examples(str(pkl))
    _same_examples(t_g, j_g)
    # sampled anchors from a small sta_dict.json
    sta = tmp_path / "sta_dict.json"
    sta.write_text(json.dumps({"x_mean": 0.5, "x_std": 0.2, "y_mean": 0.5, "y_std": 0.2}))
    _same_examples(tdata.attach_sampled_abs_targets(t_g + t_ex, str(sta),
                                                    np.random.RandomState(1)),
                   jdata.attach_sampled_abs_targets(j_g + j_ex, str(sta),
                                                    np.random.RandomState(1)))
    chain = [tdata.LayoutExample("", ["a", "b", "c", "d"], [0, 1, 2, 3],
                                 [[0, 1, "left of"], [2, 1, "right of"], [1, 3, "left of"],
                                  [0, 2, "above"], [2, 3, "above"]])]
    _same_examples(tdata.close_relations_transitively(chain + t_g, max_rels=6),
                   jdata.close_relations_transitively([_to(jdata.LayoutExample, e)
                                                       for e in chain] + j_g, max_rels=6))
    _same_examples(tdata.augment_with_templates(t_g, np.random.RandomState(2), variants=2),
                   jdata.augment_with_templates(j_g, np.random.RandomState(2), variants=2))
    for a, b in zip(tdata.augment_with_templates(t_g, np.random.RandomState(2)),
                    jdata.augment_with_templates(j_g, np.random.RandomState(2))):
        ta, ja = tdata.example_to_arrays(a, tt, 16, 2, 2), jdata.example_to_arrays(b, jt, 16, 2, 2)
        assert ta.keys() == ja.keys()
        for k in ta:
            np.testing.assert_array_equal(ta[k], ja[k])
    # COCO captions and VG-MSDN scene graphs from small JSON files
    inst = {"images": [{"id": 1, "width": 100, "height": 100}],
            "categories": [{"id": 5, "name": "dog"}, {"id": 6, "name": "cat"},
                           {"id": 7, "name": "car"}],
            "annotations": [{"image_id": 1, "category_id": c, "bbox": b} for c, b in
                            ((5, [10, 10, 30, 30]), (6, [60, 60, 30, 30]), (7, [40, 0, 40, 40]))]}
    caps = {"annotations": [{"image_id": 1, "caption": "A dog and a cat near a car."}]}
    (tmp_path / "inst.json").write_text(json.dumps(inst))
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    args = (str(tmp_path / "inst.json"), str(tmp_path / "caps.json"))
    _same_examples(tdata.load_coco_caption_examples(*args), jdata.load_coco_caption_examples(*args))
    vg = [{"id": 1, "width": 200, "height": 100,
           "objects": [{"class": "dog", "box": [0, 0, 100, 50]},
                       {"class": "traffic light", "box": [100, 50, 200, 100]}],
           "relationships": [{"sub_id": 0, "obj_id": 1, "predicate": "left of"},
                             {"sub_id": 1, "obj_id": 0, "predicate": "under"}]}]
    (tmp_path / "vg.json").write_text(json.dumps(vg))
    _same_examples(tdata.load_vg_msdn_examples(str(tmp_path / "vg.json")),
                   jdata.load_vg_msdn_examples(str(tmp_path / "vg.json")))


@pytest.fixture(scope="module")
def start():
    """JAX's 2-layer predictor and trainer, their params as numpy, and a few
    synthetic batches."""
    jcfg = JLayoutConfig(**TINY)
    _, params = jcreate(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    trainer = jtrainer.LayoutTrainer.create(jcfg, JLayoutTrainConfig(**TRAIN), params)
    examples = jdata.synthetic_examples(32, np.random.RandomState(0))
    batch_list = list(jdata.batches(examples, jtokenizer(), 8, np.random.RandomState(1),
                                    max_len=16, max_rels=2, max_objs=2))
    return trainer, params, batch_list


def _port(params):
    model = LayoutPredictor(LayoutConfig(**TINY))
    model.load_state_dict(layout_state_dict(params, model), strict=True)
    trainer = ttrainer.LayoutTrainer.create(LayoutConfig(**TINY), LayoutTrainConfig(**TRAIN))
    return trainer, model, trainer.init_state(model)


def _params_close(model, jparams, atol=1e-4):
    want = layout_state_dict(jax.tree_util.tree_map(np.asarray, jparams), model)
    for name, p in model.state_dict().items():
        if name.endswith("attn.k.bias"):      # rounding-noise gradient (module docstring)
            continue
        close(p, want[name], atol=atol, rtol=atol)


def test_three_optimizer_steps_match_jax(start):
    jt, params, batch_list = start
    trainer, model, opt = _port(params)
    opt_state = jt.init_state(params)
    for b in batch_list[:3]:
        params, opt_state, jloss, jm = jt.train_step(params, opt_state, b)
        model, opt, loss, m = trainer.train_step(model, opt, b)
        close(loss, jloss)
        for k in jm:
            close(m[k], jm[k])
    assert opt.count == 3
    _params_close(model, params)
    assert ttrainer._param_group("head.output_layer.weight") == "head"
    assert ttrainer._param_group("backbone.emb_ln.weight") == "encoder"


def test_nonfinite_step_skipped_as_apply_if_finite(start):
    jt, params, batch_list = start
    trainer, model, opt = _port(params)
    opt_state = jt.init_state(params)
    bad = batch_list[0]._replace(abs_xy=np.full_like(batch_list[0].abs_xy, np.nan),
                                 abs_valid=np.ones_like(batch_list[0].abs_valid))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params2, opt_state, jloss, _ = jt.train_step(params, opt_state, bad)
    model, opt, loss, _ = trainer.train_step(model, opt, bad)
    assert not np.isfinite(float(jloss)) and not np.isfinite(float(loss))
    assert int(opt_state.notfinite_count) == opt.notfinite_count == 1
    assert bool(opt_state.last_finite) is opt.last_finite is False
    assert opt.count == 0 and not opt.adam.state        # no moment was touched
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    # the next finite step is the first step, in both
    params2, opt_state, jloss, _ = jt.train_step(params2, opt_state, batch_list[1])
    model, opt, loss, _ = trainer.train_step(model, opt, batch_list[1])
    close(loss, jloss)
    assert int(opt_state.notfinite_count) == opt.notfinite_count == 0
    assert int(opt_state.total_notfinite) == opt.total_notfinite == 1
    _params_close(model, params2)


def test_consecutive_error_limit_matches_optax():
    """More than 100 non-finite steps in a row (JAX's max_consecutive_errors):
    the step is applied anyway, in optax and in the port."""
    cfg = LayoutTrainConfig(encoder_max_lr=1e-2, head_max_lr=1e-2, warmup_steps=1,
                            hold_steps=10, decay_steps=10)
    sched = jtrainer.bert_schedule(1e-2, 1e-8, 1, 10, 10)
    limit = ttrainer.MAX_CONSECUTIVE_ERRORS
    tx = jax.jit(optax.apply_if_finite(optax.adam(sched), max_consecutive_errors=limit).update)
    init = optax.apply_if_finite(optax.adam(sched), max_consecutive_errors=limit).init
    p = {"w": jnp.ones(3)}
    state = init(p)
    module = torch.nn.Module()
    module.head = torch.nn.Linear(3, 1, bias=False)
    module.head.weight.data.fill_(1.0)
    opt = ttrainer.Optimizer(cfg, module)
    applied = []
    for step in range(limit + 3):
        g = jnp.full(3, jnp.nan) if step < limit + 2 else jnp.full(3, 0.5)
        upd, state = tx({"w": g}, state, p)
        p = optax.apply_updates(p, upd)
        module.head.weight.grad = torch.from_numpy(np.array(g)).reshape(1, 3)
        applied.append(opt.update())
        assert int(state.notfinite_count) == opt.notfinite_count
        got, want = module.head.weight.detach().numpy()[0], np.asarray(p["w"])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert applied == [False] * limit + [True] * 3


def test_eval_step_metrics_match_jax(start):
    jt, params, batch_list = start
    trainer, model, _ = _port(params)
    for b in batch_list[:2]:
        jloss, jm = jt.eval_step(params, b)
        loss, m = trainer.eval_step(model, b)
        close(loss, jloss)
        assert set(m) == set(jm) >= {"mean_center_dist", "rel_satisfied"}
        for k in jm:
            close(m[k], jm[k])


def test_save_restore_gives_equal_bits(start, tmp_path):
    """A checkpoint restores equal bits and the next step equals; the
    trainer takes a mesh with a model axis: over a (1, 2) mesh of two gloo
    ranks (fsdp asked: a data axis of 1 shards nothing) each rank's step is
    the one-process step."""
    from helpers.torch_ranks import model_axis_ranks

    _, params, batch_list = start
    _, model0, _ = _port(params)
    (tmp_path / "ranks").mkdir()
    ranks = model_axis_ranks(str(tmp_path / "ranks"), {"layout": dict(
        cfg=LayoutConfig(**TINY), train_cfg=LayoutTrainConfig(**TRAIN),
        state=model0.state_dict(), batches=[tuple(batch_list[0])])})
    trainer, model, opt = _port(params)
    model, opt, _, _ = trainer.train_step(model, opt, batch_list[0])
    trainer.save_checkpoint(str(tmp_path), 1, model, opt, extra={"epoch": 0})
    _, model2, opt2 = _port(params)
    model2, opt2 = trainer.restore_checkpoint(str(tmp_path), 1, model2, opt2)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 model2.state_dict().values()))
    assert opt2.count == 1
    model, opt, loss, _ = trainer.train_step(model, opt, batch_list[1])
    model2, opt2, loss2, _ = trainer.train_step(model2, opt2, batch_list[1])
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 model2.state_dict().values()))
    trainer, model1, opt1 = _port(params)
    _, _, loss1, _ = trainer.train_step(model1, opt1, batch_list[0])
    for o in (r["model_axis_trainers"] for r in ranks.join()):
        got = o["layout"]
        assert o["devices"] == 2 and got["n_moments"] > 0 and got["sharded_moments"] == 0
        assert got["losses"][0]["loss"] == pytest.approx(float(loss1), rel=1e-6)
        for k, v in model1.state_dict().items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_train_layout_run_dir_loads(tmp_path):
    run = tmp_path / "run"
    out = train_layout.main(["--cpu", "--synthetic", "24", "--layers", "1", "--heads", "2",
                             "--batch-size", "8", "--epochs", "2", "--ckpt-dir", str(run),
                             "--log-every", "1"])
    assert out["steps"] == 4 and len(out["train_losses"]) == 4
    assert np.isfinite(out["train_losses"]).all()
    assert out["best"]["params_path"] == "best_params.pt"
    assert {p.name for p in run.iterdir()} >= {"config.json", "best.json", "best_params.pt",
                                               "train_log.jsonl", "step_4.pt"}
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["layout"]["layers"] == 1 and cfg["train"]["batch_size"] == 8
    model = loader.load_layout_predictor(LayoutConfig(), str(run), device="cpu")
    assert model.cfg.layers == 1 and model.cfg.heads == 2
    best = torch.load(run / "best_params.pt", weights_only=True)
    assert all(torch.equal(v, best[k]) for k, v in model.state_dict().items())
    tokens = torch.from_numpy(np.random.RandomState(3).randint(3, 1000, (4, 12)))
    ref = LayoutPredictor(model.cfg)
    ref.load_state_dict(best)
    torch.testing.assert_close(model.predict_xy(tokens, greedy_component=True)[0],
                               ref.predict_xy(tokens, greedy_component=True)[0], atol=0, rtol=0)
    # resume from the final checkpoint
    again = train_layout.main(["--cpu", "--synthetic", "24", "--layers", "1", "--heads", "2",
                               "--batch-size", "8", "--epochs", "1", "--ckpt-dir", str(run),
                               "--resume-step", "4"])
    assert again["steps"] == 6
    # --fsdp on one device is ignored, as in JAX (the mesh runs are
    # tests/test_torch_parallel_training.py's)
    one = train_layout.main(["--cpu", "--synthetic", "8", "--layers", "1", "--heads", "2",
                             "--batch-size", "8", "--epochs", "1", "--fsdp",
                             "--ckpt-dir", str(tmp_path / "fsdp")])
    assert one["steps"] == 1 and np.isfinite(one["train_losses"]).all()


def test_bench_train_layout_keys_match_jax():
    line = bench_train.main(["--what", "layout", "--cpu", "--iters", "1", "--batch-size", "4",
                             "--gpt3-pkl", "absent.pkl"])
    assert line["metric"] == "layout_pretrain_step_b4_synthetic"
    assert {"metric", "iters", "s_per_step", "items_per_s", "compile_s", "times",
            "device"} <= set(line)
    assert line["iters"] == len(line["times"]) == 1 and line["device"] == "cpu"


def test_layout_tools_read_only_the_data_paths_given(tmp_path):
    # no default data path: without one, bench_train takes synthetic
    # sentences and train_layout asks for a source
    assert bench_train.parse_args(["--what", "layout"]).gpt3_pkl is None
    args = train_layout.parse_args([])
    assert args.gpt3_pkl is None and args.abs_stats is None
    with pytest.raises(SystemExit, match="--gpt3-pkl"):
        train_layout.main(["--cpu", "--ckpt-dir", str(tmp_path / "run")])
