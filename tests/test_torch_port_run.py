"""The port's training run (buckgnn_tpu_torch.train.trainer.train_gnn), its
checkpoints (train/checkpoint.py, convert.py) and serving
(eval/inference.py) == the JAX package's.

Runs go on tests/test_train.py's tiny set (24 panels of 3-5 nodes a side;
H 16, 2 layers, batch 6) on the CPU, in float32, at dropout 0. The weights
cross by the checkpoint reader: the JAX package's own `save_checkpoint`
writes a JAX `init_state` at epoch 0, and both packages' `train_gnn` start
from it with `resume_from`. One module-scoped fixture runs the JAX
`train_gnn`; the geometry test starts two more and stops them at their
first pack.
"""

import csv
import dataclasses
import glob
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buckgnn_tpu import config as jconfig
from buckgnn_tpu.eval import inference as jinf
from buckgnn_tpu.graph import batch as jb
from buckgnn_tpu.graph import normalizer as jnorm
from buckgnn_tpu.graph.synthetic import generate_dataset as j_generate
from buckgnn_tpu.train import checkpoint as jckpt
from buckgnn_tpu.train import trainer as jtr
from buckgnn_tpu.train.losses import get_loss_function as j_loss
from buckgnn_tpu_torch import config
from buckgnn_tpu_torch.convert import (
    params_from_flax, read_flax_msgpack, state_from_flax,
)
from buckgnn_tpu_torch.eval import inference
from buckgnn_tpu_torch.graph import batch as tb
from buckgnn_tpu_torch.graph.normalizer import (
    DatasetNormalizer, normalize_dataset,
)
from buckgnn_tpu_torch.graph.synthetic import generate_dataset
from buckgnn_tpu_torch.train import checkpoint as ckpt
from buckgnn_tpu_torch.train import trainer
from buckgnn_tpu_torch.train.losses import get_loss_function

# Per-epoch losses, MAPEs and the final parameters of the 3-epoch runs
# (9 Adam steps from the same weights, float32): each step's loss agrees
# to f32 round-off (tests/test_torch_port_train.py holds three steps to
# 1e-5), and so do the epoch means; Adam divides each gradient by its own
# running scale, so the parameters agree to round-off of lr-sized
# updates, 1e-6 a step: 1e-5 absolute after nine.
RUN_RTOL = 1e-5
PARAM_ATOL = 1e-5
# The MAPE rows of run_inference: the same weights and graphs in float32,
# a per-graph mean of |t - p| / |t| in percent: f32 round-off of pred.
MAPE_RTOL = 1e-5


def _cfgs(**kw):
    """The JAX and the port's TrainConfig of the tiny runs."""
    base = dict(hidden_channels=16, num_layers=2, num_epochs=3, batch_size=6,
                lr=1e-3, t_0=10, seed=0, dropout_rate=0.0)
    base.update(kw)
    return jconfig.TrainConfig(**base), config.TrainConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_train.py's tiny set from each package's generator and
    normalizer: 18 train and 6 val panels."""
    jds, jnz = jnorm.normalize_dataset(j_generate(24, seed=0, min_side=3,
                                                  max_side=5))
    ds, nz = normalize_dataset(generate_dataset(24, seed=0, min_side=3,
                                                max_side=5))
    return dict(jtrain=jds[:18], jval=jds[18:], jnz=jnz, train=ds[:18],
                val=ds[18:], nz=nz)


def _jax_state(jcfg, graphs, batch_size):
    """(model, optimizer, init_state, first batch) of the JAX package."""
    ncap, ecap = jb.suggest_capacities(graphs, batch_size)
    batch = next(iter(jb.batch_iterator(graphs, batch_size, ncap, ecap)))
    model = jtr.build_model(jcfg, graphs[0].x.shape[1],
                            graphs[0].edge_attr.shape[1])
    opt = jtr.make_optimizer(jcfg)
    return model, opt, jtr.init_state(model, opt, batch), batch


def _save_jax(path, jcfg, state, graphs, nz):
    jckpt.save_checkpoint(path, state, jcfg, jconfig.checkpoint_config_dict(
        jcfg, graphs[0].x.shape[1], graphs[0].edge_attr.shape[1]), nz)


@pytest.fixture(scope="module")
def start(tiny, tmp_path_factory):
    """A JAX init_state written by the JAX save_checkpoint at epoch 0."""
    jcfg, _ = _cfgs()
    path = str(tmp_path_factory.mktemp("start") / "init")
    _save_jax(path, jcfg, _jax_state(jcfg, tiny["jtrain"], 6)[2],
              tiny["jtrain"], tiny["jnz"])
    return path


@pytest.fixture(scope="module")
def runs(tiny, start, tmp_path_factory):
    """Both packages' 3-epoch train_gnn from the JAX checkpoint."""
    jcfg, cfg = _cfgs()
    out = tmp_path_factory.mktemp("runs")
    jres = jtr.train_gnn(jcfg, tiny["jtrain"], tiny["jval"], tiny["jnz"],
                         str(out / "jax"), trial_id="parity",
                         resume_from=start, verbose=False)
    res = trainer.train_gnn(cfg, tiny["train"], tiny["val"], tiny["nz"],
                            str(out / "port"), trial_id="parity",
                            resume_from=start, verbose=False, device="cpu")
    return jres, res, out


# ---- configs, normalizer, the msgpack reader -----------------------------

def test_configs_round_trip_and_load_across_packages():
    """The JSON round trip; a JAX train_config.json (with rng_impl) loads in
    the port and the port's in the JAX package; the field order is the JAX
    one less rng_impl (results.txt writes the fields in order);
    checkpoint_config_dict and DataConfig equal the JAX ones."""
    jcfg, cfg = _cfgs(lr=3e-3, min_lr=1e-5, remat=True,
                      segment_impl="banded_pallas", compute_dtype="bfloat16",
                      repack_every_epoch=True, profile_epochs=2)
    assert config.TrainConfig.from_json(cfg.to_json()) == cfg
    assert config.TrainConfig.from_json(jcfg.to_json()) == cfg
    assert jconfig.TrainConfig.from_json(cfg.to_json()) == jcfg
    names = [f.name for f in dataclasses.fields(config.TrainConfig)]
    assert names == [f.name for f in dataclasses.fields(jconfig.TrainConfig)
                     if f.name != "rng_impl"]
    assert (config.checkpoint_config_dict(cfg, 15, 5)
            == jconfig.checkpoint_config_dict(jcfg, 15, 5))
    assert (dataclasses.asdict(config.DataConfig())
            == dataclasses.asdict(jconfig.DataConfig()))
    assert list(dataclasses.asdict(config.DataConfig())) == list(
        dataclasses.asdict(jconfig.DataConfig()))


@pytest.mark.parametrize("prediction_type", ["buckling", "static_stress"])
def test_normalizer_npz_loads_in_both_packages(tmp_path, prediction_type):
    """A normalizer saved by either package loads in the other with the
    same arrays under the same keys."""
    kw = dict(seed=3, min_side=3, max_side=5, prediction_type=prediction_type)
    _, jnz = jnorm.normalize_dataset(j_generate(6, **kw),
                                     prediction_type=prediction_type)
    _, nz = normalize_dataset(generate_dataset(6, **kw),
                              prediction_type=prediction_type)
    nz.save(str(tmp_path / "port.npz"))
    jnz.save(str(tmp_path / "jax.npz"))
    for got, want in (
            (jnorm.DatasetNormalizer.load(str(tmp_path / "port.npz")), nz),
            (DatasetNormalizer.load(str(tmp_path / "jax.npz")), jnz)):
        a, b = got.to_arrays(), want.to_arrays()
        assert a.keys() == b.keys() and len(a) >= 8
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_msgpack_reader_matches_flax(tmp_path, monkeypatch):
    """read_flax_msgpack == flax's msgpack_restore: nested dicts, tuples
    (dicts keyed '0', '1'), int32 and float32 arrays, numpy scalars, Python
    numbers, bfloat16 (as exact float32) and leaves chunked past the chunk
    size (shrunk here so a small array splits)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "params": {"a": {"kernel": rng.normal(size=(7, 5)).astype(
            np.float32)}, "b": np.arange(40, dtype=np.int32)},
        "half": jnp.asarray(rng.normal(size=(3, 4)), dtype=jnp.bfloat16),
        "opt": (flax.serialization.to_state_dict(()), {"count": np.int32(7)}),
        "epoch": 3, "rate": 0.5, "empty": {},
    }
    path = tmp_path / "s.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        flax.serialization.to_state_dict(tree)))
    got = read_flax_msgpack(str(path))
    want = flax.serialization.msgpack_restore(path.read_bytes())
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["params"]["a"]["kernel"],
                                  want["params"]["a"]["kernel"])
    np.testing.assert_array_equal(got["params"]["b"], want["params"]["b"])
    assert got["params"]["b"].dtype == np.int32
    assert got["half"].dtype == np.float32
    np.testing.assert_array_equal(got["half"],
                                  np.asarray(want["half"], np.float32))
    assert got["opt"]["1"]["count"] == 7 and got["opt"]["0"] == {}
    assert (got["epoch"], got["rate"], got["empty"]) == (3, 0.5, {})


def test_jax_checkpoint_resumes_with_its_adam_state(tiny, tmp_path):
    """After one JAX train step (non-zero moments) the JAX checkpoint loads
    into the port bit for bit: parameters, the batch norms' running
    statistics, and Adam's exp_avg, exp_avg_sq and step; the epoch too.
    The next step then matches the JAX step as
    tests/test_torch_port_train.py holds three: the loss to 1e-5 relative,
    the parameters to 1e-6."""
    jcfg, cfg = _cfgs(model_name="GraphSage_meanAggr", weight_decay=1e-2)
    graphs, lr = tiny["jtrain"][:6], 1e-3
    jmodel, opt, jstate, jbatch = _jax_state(jcfg, graphs, 6)
    j_step, _ = jtr.make_train_step(jmodel, opt, j_loss(jcfg.loss_function),
                                    jcfg, tiny["jnz"])
    jstate, _ = j_step(jstate, jbatch, jax.random.key(1), jnp.float32(lr))
    jstate = jstate.replace(epoch=5)
    path = str(tmp_path / "ck")
    _save_jax(path, jcfg, jstate, graphs, tiny["jnz"])

    model = trainer.build_model(cfg, graphs[0].x.shape[1],
                                graphs[0].edge_attr.shape[1], device="cpu")
    optimizer = trainer.make_optimizer(cfg, model)
    epoch, tcfg, ccfg, nz = ckpt.load_checkpoint(path, model, optimizer)
    assert (epoch, tcfg, ccfg["model_name"]) == (5, cfg, cfg.model_name)
    host = jax.tree.map(np.asarray, jstate)
    want = state_from_flax(host.params, host.batch_stats)
    got = model.state_dict()
    assert got.keys() == want.keys() and any("mean" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    adam = host.opt_state[1]
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    names = [n for n, _ in model.named_parameters()]
    assert len(optimizer.state) == len(names)
    for name, p in zip(names, model.parameters()):
        s = optimizer.state[p]
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name
        assert float(s["step"]) == int(adam.count) == 1
        assert float(s["exp_avg_sq"].abs().max()) > 0.0

    jstate, jm = j_step(jstate, jbatch, jax.random.key(1), jnp.float32(lr))
    ncap, ecap = jb.suggest_capacities(graphs, 6)
    batch = next(iter(tb.batch_iterator(tiny["train"][:6], 6, ncap, ecap,
                                        device="cpu")))
    step, _ = trainer.make_train_step(model, optimizer, get_loss_function(
        cfg.loss_function), cfg, nz)
    m = step(batch, lr, None)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    ended = state_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ended[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# ---- the training run ------------------------------------------------------

def test_train_gnn_matches_jax(runs):
    """Three epochs on impl 'xla' from the JAX checkpoint: every epoch's
    losses, MAPEs and learning rate, the best val MAPE and the final
    parameters equal the JAX run's (RUN_RTOL, PARAM_ATOL)."""
    jres, res, _ = runs
    assert [h["epoch"] for h in res.history] == [0, 1, 2]
    for h, jh in zip(res.history, jres.history, strict=True):
        assert h.keys() == jh.keys()
        assert h["epoch"] == jh["epoch"] and h["lr"] == jh["lr"]
        for k in ("train_loss", "val_loss", "train_mape", "val_mape"):
            np.testing.assert_allclose(h[k], jh[k], rtol=RUN_RTOL,
                                       err_msg=k)
    np.testing.assert_allclose(res.best_val_mape, jres.best_val_mape,
                               rtol=RUN_RTOL)
    best = [h["val_mape"] for h in res.history]
    jbest = [h["val_mape"] for h in jres.history]
    assert np.argmin(best) == np.argmin(jbest)
    assert res.state.epoch == int(jres.state.epoch) == 3
    want = state_from_flax(jax.tree.map(np.asarray, jres.state.params))
    got = res.state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    for d in ("last", "best"):
        assert os.path.exists(os.path.join(res.log_dir, "weights", d,
                                           "state.pt"))


def test_results_txt_matches_jax(runs):
    """results.txt holds the JAX run's text, but for the rng_impl line the
    port's TrainConfig has not."""
    jres, res, _ = runs
    with open(os.path.join(jres.log_dir, "results.txt")) as f:
        want = f.read().replace("rng_impl : rbg\n\n", "")
    with open(os.path.join(res.log_dir, "results.txt")) as f:
        got = f.read()
    assert got == want
    assert got.count("Epoch ") == 3


class _Packed(Exception):
    pass


@pytest.mark.parametrize("model_name", ["GraphSage_addAggr_Shared",
                                        "EA_GNN_Shared"])
def test_packing_geometry_matches_jax(tmp_path, monkeypatch, model_name):
    """A banded run packs as the JAX trainer does (mirrors
    tests/test_train.py::test_trainer_selects_ea_tile_geometry): the same
    band tile and width (EA models tile 128), node capacity (4-tile
    aligned), edge capacity, RCM and pack-time band. Each trainer is
    stopped at its first pack."""
    kw = dict(seed=7, min_side=8, max_side=10, use_virtual_edges=True)
    jds, jnz = jnorm.normalize_dataset(j_generate(10, **kw))
    ds, nz = normalize_dataset(generate_dataset(10, **kw))
    jcfg, cfg = _cfgs(hidden_channels=128, num_epochs=1, batch_size=4,
                      segment_impl="banded_pallas", model_name=model_name)
    seen = {}

    def spy(name):
        def stop(data, batch_size, n_node_cap, n_edge_cap, **k):
            k.pop("device", None)
            seen[name] = dict(k, n_node_cap=n_node_cap,
                              n_edge_cap=n_edge_cap, batch_size=batch_size)
            raise _Packed
        return stop

    monkeypatch.setattr(jtr, "batch_iterator", spy("jax"))
    monkeypatch.setattr(trainer, "batch_iterator", spy("port"))
    with pytest.raises(_Packed):
        jtr.train_gnn(jcfg, jds[:8], jds[8:], jnz, str(tmp_path / "j"),
                      verbose=False)
    with pytest.raises(_Packed):
        trainer.train_gnn(cfg, ds[:8], ds[8:], nz, str(tmp_path / "p"),
                          verbose=False, device="cpu")
    assert seen["port"] == seen["jax"]
    tile = 128 if model_name.startswith("EA_") else 256
    assert seen["port"]["band_tile"] == tile
    assert seen["port"]["band_width"] <= 128
    assert seen["port"]["n_node_cap"] % (4 * tile) == 0
    assert seen["port"]["rcm"] and seen["port"]["materialize_band"]


def test_resume_is_exact(tiny, tmp_path):
    """Two epochs, then a resume from weights/last to four, equal four
    uninterrupted epochs bit for bit at dropout 0: the resumed history
    holds epochs 2 and 3, and its losses, the parameters, the batch
    norms' statistics and the Adam state are the same."""
    _, cfg = _cfgs(num_epochs=4, model_name="GraphSage_meanAggr")
    args = (tiny["train"], tiny["val"], tiny["nz"])
    whole = trainer.train_gnn(cfg, *args, str(tmp_path / "a"),
                              verbose=False, device="cpu")
    first = trainer.train_gnn(dataclasses.replace(cfg, num_epochs=2), *args,
                              str(tmp_path / "b"), verbose=False,
                              device="cpu")
    rest = trainer.train_gnn(cfg, *args, str(tmp_path / "c"),
                             resume_from=os.path.join(first.log_dir,
                                                      "weights", "last"),
                             verbose=False, device="cpu")
    assert [h["epoch"] for h in rest.history] == [2, 3]
    assert rest.history == whole.history[2:]
    got, want = rest.state.model.state_dict(), whole.state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    go, wo = (rest.state.optimizer.state_dict(),
              whole.state.optimizer.state_dict())
    assert go["state"].keys() == wo["state"].keys()
    for i in wo["state"]:
        for k, v in wo["state"][i].items():
            assert torch.equal(go["state"][i][k], v), (i, k)
    assert rest.state.epoch == whole.state.epoch == 4


@pytest.mark.parametrize("prediction_type,epochs", [("static_disp", 2),
                                                    ("mode_shape", 3)])
def test_node_level_runs_are_finite(tmp_path, prediction_type, epochs):
    """static_disp and mode_shape runs (tests/test_train.py:159-185): the
    static targets are sliced, the losses finite; mode_shape's falls."""
    ds = generate_dataset(12, seed=1 if prediction_type == "static_disp"
                          else 2, min_side=3, max_side=4,
                          prediction_type=prediction_type)
    normed, nz = normalize_dataset(ds, prediction_type=prediction_type)
    _, cfg = _cfgs(prediction_type=prediction_type, loss_function="graph_mae",
                   num_epochs=epochs, batch_size=4, dropout_rate=0.1)
    res = trainer.train_gnn(cfg, normed[:8], normed[8:], nz, str(tmp_path),
                            verbose=False, device="cpu")
    assert len(res.history) == epochs
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in res.history)
    if prediction_type == "mode_shape":
        assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]


def test_profile_epochs_writes_a_trace(tiny, tmp_path):
    _, cfg = _cfgs(num_epochs=2, profile_epochs=1)
    res = trainer.train_gnn(cfg, tiny["train"][:6], tiny["val"], tiny["nz"],
                            str(tmp_path), verbose=False, device="cpu")
    traces = glob.glob(os.path.join(res.log_dir, "profile", "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    # the trainer's profiled epochs carry the port's own spans
    assert any(e.get("name") == "buckgnn.train.step" for e in events)


def test_banded_partitioned_raises(tiny, start, tmp_path, monkeypatch):
    """segment_impl="banded_partitioned" no longer raises: without a mesh
    it packs one shard (``part`` on every batch) and three epochs from the
    JAX checkpoint equal the JAX run's at dropout 0 (losses, MAPEs, the
    final parameters), as test_train_gnn_matches_jax holds impl 'xla'."""
    jcfg, cfg = _cfgs(segment_impl="banded_partitioned")
    jres = jtr.train_gnn(jcfg, tiny["jtrain"], tiny["jval"], tiny["jnz"],
                         str(tmp_path / "jax"), trial_id="part",
                         resume_from=start, verbose=False)
    packs = []
    real = trainer.attach_shards

    def spy(*a, **k):
        packs.append(real(*a, **k))
        return packs[-1]

    monkeypatch.setattr(trainer, "attach_shards", spy)
    res = trainer.train_gnn(cfg, tiny["train"], tiny["val"], tiny["nz"],
                            str(tmp_path / "port"), trial_id="part",
                            resume_from=start, verbose=False, device="cpu")
    assert packs and all(b.part is not None and b.part.n_shards == 1
                         for p in packs for b in p)
    for h, jh in zip(res.history, jres.history, strict=True):
        for k in ("train_loss", "val_loss", "train_mape", "val_mape"):
            np.testing.assert_allclose(h[k], jh[k], rtol=RUN_RTOL,
                                       err_msg=k)
    want = state_from_flax(jax.tree.map(np.asarray, jres.state.params))
    got = res.state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_train_gnn_needs_a_card_unless_asked(tiny, tmp_path, monkeypatch):
    """Without device="cpu" and without a card the run raises before it
    writes anything; it never carries on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train_gnn(cfg, tiny["train"], tiny["val"], tiny["nz"],
                          str(tmp_path / "o"), verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.run_inference(str(tmp_path / "none"), tiny["val"],
                                str(tmp_path / "i"))
    assert not os.path.exists(tmp_path / "o")


# ---- serving a checkpoint --------------------------------------------------

def test_run_inference_on_a_jax_checkpoint_matches_jax(runs, tiny):
    """run_inference on the JAX run's weights/best gives the JAX
    run_inference's MAPE, MIN MAPE and MAX MAPE (MAPE_RTOL) and the same
    report CSV row; on the port's own best its MAPE is the best epoch's
    logged val MAPE."""
    jres, res, out = runs
    best = os.path.join(jres.log_dir, "weights", "best")
    want = jinf.run_inference(best, tiny["jval"], str(out / "ji"),
                              batch_size=6, report_path=str(out / "j.csv"),
                              data_dir="val")
    got = inference.run_inference(best, tiny["val"], str(out / "pi"),
                                  batch_size=6,
                                  report_path=str(out / "p.csv"),
                                  data_dir="val", device="cpu")
    assert got.keys() == want.keys() == {"MAPE", "MIN MAPE", "MAX MAPE"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=MAPE_RTOL,
                                   err_msg=k)
    with open(out / "j.csv") as f:
        jrows = list(csv.DictReader(f))
    with open(out / "p.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(jrows) == 1
    assert list(rows[0]) == list(jrows[0])
    for k, v in jrows[0].items():
        if k in inference.BUCKLING_METRICS:
            np.testing.assert_allclose(float(rows[0][k]), float(v),
                                       rtol=MAPE_RTOL, err_msg=k)
        else:
            assert rows[0][k] == v, k
    with open(out / "pi" / "inference_results.txt") as f:
        assert f.read().startswith("Final Test MAPE: ")

    own = inference.run_inference(os.path.join(res.log_dir, "weights",
                                               "best"), tiny["val"],
                                  str(out / "own"), batch_size=6,
                                  device="cpu")
    np.testing.assert_allclose(own["MAPE"], res.best_val_mape,
                               rtol=MAPE_RTOL)
