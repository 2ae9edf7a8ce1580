"""A checkpoint the JAX command line trains, served by the port's.

The JAX CLI's ``train`` writes ``weights/best`` (float32, H 16, 2 layers,
2 epochs, dropout 0) from a folder of (bdf, fea.npz) pairs; the port's
``infer --device cpu`` on that checkpoint and folder prints the JAX
``infer``'s MAPE, MIN MAPE and MAX MAPE, from the same predictions. The
folder holds synthetic panels (graph/synthetic.py), whose eigenvalues
vary: every ``datagen`` case carries the same target (ROADMAP §3), which
would leave a MAPE of float32 round-off alone.
"""

import json
import os

import numpy as np
import pytest

import buckgnn_tpu.cli as jcli
import buckgnn_tpu.eval.inference as jinf
import buckgnn_tpu_torch.cli as tcli
import buckgnn_tpu_torch.eval.inference as tinf
from buckgnn_tpu_torch.graph.folder import save_fea_npz
from buckgnn_tpu_torch.graph.mesh import write_bdf
from buckgnn_tpu_torch.graph.synthetic import fake_fea, generate_mesh

# The same float32 weights on the same graphs: f32 round-off of pred, and
# of the per-graph |t - p| / |t| means built from it.
PRED_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """8 synthetic panels in one folder, and the JAX CLI's train on it."""
    root = tmp_path_factory.mktemp("interop")
    data = root / "cases"
    data.mkdir()
    for i in range(8):
        mesh = generate_mesh(seed=40 + i, min_side=3, max_side=5)
        write_bdf(mesh, str(data / f"panel_{i}.bdf"))
        save_fea_npz(fake_fea(mesh, seed=40 + i),
                     str(data / f"panel_{i}.fea.npz"))
    assert jcli.main(["train", "--data-dir", str(data), "--output-dir",
                      str(root / "runs"), "--hidden-channels", "16",
                      "--num-layers", "2", "--num-epochs", "2",
                      "--batch-size", "8", "--dropout-rate", "0"]) == 0
    (log,) = os.listdir(root / "runs" / "tensorboard_logs")
    return root, str(root / "runs" / "tensorboard_logs" / log / "weights"
                     / "best")


def _recording(module, name, preds):
    """Wrap the eval-step factory ``module.name`` so each call's real
    graphs' predictions are kept, in order."""
    real = getattr(module, name)

    def factory(*a, **kw):
        made = real(*a, **kw)
        step = made[1] if isinstance(made, tuple) else made

        def recording_step(*args):
            m, (pred, aux) = step(*args)
            preds.append(np.asarray(pred)[np.asarray(args[-1].graph_mask)])
            return m, (pred, aux)

        return (made[0], recording_step) if isinstance(made, tuple) \
            else recording_step

    return factory


def test_port_infer_on_a_jax_cli_checkpoint(jax_run, capsys, monkeypatch,
                                            tmp_path):
    root, best = jax_run
    assert os.path.exists(os.path.join(best, "state.msgpack"))
    jpreds, tpreds = [], []
    monkeypatch.setattr(jinf, "make_train_step",
                        _recording(jinf, "make_train_step", jpreds))
    monkeypatch.setattr(tinf, "make_eval_step",
                        _recording(tinf, "make_eval_step", tpreds))
    out = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["infer", "--model-path", best, "--data-dir",
                     str(root / "cases"), "--output-dir",
                     str(tmp_path / str(len(out))), "--batch-size", "8"]
                    + extra) == 0
        out.append(json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1]))
    assert out[0].keys() == out[1].keys() == {"MAPE", "MIN MAPE",
                                              "MAX MAPE"}
    for k in out[0]:
        np.testing.assert_allclose(out[1][k], out[0][k], rtol=PRED_RTOL,
                                   err_msg=k)
    assert out[1]["MAX MAPE"] > out[1]["MIN MAPE"]
    jp, tp = np.concatenate(jpreds), np.concatenate(tpreds)
    assert jp.shape == tp.shape == (8,)
    np.testing.assert_allclose(tp, jp, rtol=PRED_RTOL, atol=PRED_RTOL)
