"""How far the ea-virtual cell's two bf16 paths lie from each other and
from float32, on one CUDA card.

    python3 tools/ea_bf16_noise.py

On the ea-virtual train setup (``bench.py::build_train_setup``), with its
fresh weights and again after 15 train steps, for generator seeds 11-18:
one train step's loss gradients and the gradients of `chip_smoke.py`'s
linear readout of the pooled features, by the kernel path, by the plain
path and by the plain path of a float32 copy of the model; prints, per
case, the largest relative error over the parameters of each pair, the
predictions' largest differences, and how many of the decoder's relu
decisions flip between the paths. The measurement behind chip_smoke.py's
``EA_PRED_TOL`` and its readout gradient check.
"""

import dataclasses
import json
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from buckgnn_tpu_torch.bench import build_train_setup
    from buckgnn_tpu_torch.train.trainer import build_model

    dev = torch.device("cuda", 0)
    tr = build_train_setup(device=dev, config="ea-virtual")
    model, batch = tr["state"].model, tr["batch"]
    gm = batch.graph_mask
    card = cs.card_line()

    def run(setup, seed, readout, plain):
        """(pred, the decoder's pre-activations, grads) of one step."""
        seen = []
        m = setup["state"].model
        hooks = [lin.register_forward_hook(
            lambda mod, a, out: seen.append(out.detach().float()))
            for lin in (m.decoder.lin_0, m.decoder.lin_1, m.decoder.lin_2)]
        try:
            if plain:
                with cs.plain_kernels():
                    _, grads = cs.step_grads(setup, seed, readout)
            else:
                _, grads = cs.step_grads(setup, seed, readout)
        finally:
            for hk in hooks:
                hk.remove()
        return seen[-1][:, 0], seen[:-1], grads

    def worst(a, b):
        return max(float((a[k].float() - b[k].float()).norm()
                         / b[k].float().norm().clamp_min(1e-30)) for k in b)

    for state in ("fresh", "trained"):
        if state == "trained":
            for _ in range(15):
                tr["train_step"](batch, tr["lr"], tr["generator"])
        cfg32 = dataclasses.replace(tr["cfg"], compute_dtype="float32")
        m32 = build_model(cfg32, batch.nodes.shape[1], 5, device=dev)
        m32.load_state_dict(model.state_dict())
        ref = dict(tr, state=types.SimpleNamespace(model=m32), cfg=cfg32)
        for seed in range(11, 19):
            line = {"state": state, "seed": seed, "card": card}
            for readout in (False, True):
                pk, hk, gk = run(tr, seed, readout, False)
                pp, hp, gp = run(tr, seed, readout, True)
                pf, hf, gf = run(ref, seed, readout, True)
                tag = "readout" if readout else "loss"
                line.update({
                    f"{tag}_kernel_vs_plain": worst(gk, gp),
                    f"{tag}_kernel_vs_f32": worst(gk, gf),
                    f"{tag}_plain_vs_f32": worst(gp, gf)})
            line.update({
                "pred_abs_max": float(pf[gm].abs().max()),
                "pred_kernel_vs_plain": float((pk - pp)[gm].abs().max()),
                "pred_kernel_vs_f32": float((pk - pf)[gm].abs().max()),
                "pred_plain_vs_f32": float((pp - pf)[gm].abs().max()),
                "decoder_flips_kernel_vs_plain": [
                    int(((a > 0) != (b > 0))[gm].sum())
                    for a, b in zip(hk, hp)],
                "decoder_flips_kernel_vs_f32": [
                    int(((a > 0) != (b > 0))[gm].sum())
                    for a, b in zip(hk, hf)]})
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
