"""How far the port's bf16 SemAbs3D (OVSSC) step lies from the JAX
package's, on the CPU, at the small config of ``tests/test_torch_ovssc.py``.

    JAX_PLATFORMS=cpu python scripts/torch_ovssc_bf16_readings.py [seed ...]

For each batch seed (6-10 unless given) prints, as one JSON line:
- the bf16 train step's loss and grad norm relative to JAX's bf16 step,
  and its accuracy difference;
- the port's bf16-vs-f32 mean |logit diff| over JAX's (``drift_ratio``),
  and the port-vs-JAX bf16 mean |logit diff| over JAX's bf16-vs-f32
  (``gap_over_jax_drift``); the grad norm's bf16-vs-f32 move over JAX's
  (``grad_norm_move_ratio``), and JAX's own bf16-vs-f32 moves of the grad
  norm and the loss relative to its f32 step (``jax_grad_norm_move``,
  ``jax_loss_move``);
- the control: the bf16 forward-loss of the port as it is and with JAX's
  roundings (``ovssc_bf16_control_runs``), as loss relative to JAX's, mean
  |logit diff| to JAX's and the share of logits equal bit for bit.

These are the readings that ``tests/test_torch_ovssc.py``'s bf16
tolerances are set from.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from test_torch_ovssc import OVSSC_CASE, _batch, ovssc_bf16_control_runs  # noqa: E402
from torch_net_cases import bf16_and_f32_runs  # noqa: E402


def readings(seed: int) -> dict:
    runs = bf16_and_f32_runs(OVSSC_CASE, OVSSC_CASE.jax_params(),
                             _batch(np.random.RandomState(seed), 1))
    (port, plog), (jax_, jlog) = runs["port", "bf16"], runs["jax", "bf16"]
    (port32, plog32), (jax32, jlog32) = runs["port", "f32"], runs["jax", "f32"]
    jax_drift = float(np.abs(jlog - jlog32).mean())
    out = {
        "seed": seed,
        "step_loss_rel": abs(port["loss"] - jax_["loss"]) / abs(jax_["loss"]),
        "step_grad_norm_rel": abs(port["grad_norm"] - jax_["grad_norm"]) / jax_["grad_norm"],
        "step_accuracy_diff": abs(port["accuracy"] - jax_["accuracy"]),
        "f32_grad_norm_rel": abs(port32["grad_norm"] - jax32["grad_norm"]) / jax32["grad_norm"],
        "drift_ratio": float(np.abs(plog - plog32).mean()) / jax_drift,
        "gap_over_jax_drift": float(np.abs(plog - jlog).mean()) / jax_drift,
        "grad_norm_move_ratio": (abs(port["grad_norm"] - port32["grad_norm"])
                                 / abs(jax_["grad_norm"] - jax32["grad_norm"])),
        "jax_grad_norm_move": abs(jax_["grad_norm"] - jax32["grad_norm"]) / jax32["grad_norm"],
        "jax_loss_move": abs(jax_["loss"] - jax32["loss"]) / abs(jax32["loss"]),
    }
    ctrl = ovssc_bf16_control_runs(seed)
    jl, jlog = ctrl["jax"]
    for name in ("port", "port, JAX's roundings"):
        loss, logits = ctrl[name]
        out[name] = {"loss_rel": abs(loss - jl) / abs(jl),
                     "mean_abs_logit_diff": float(np.abs(logits - jlog).mean()),
                     "logits_equal": float((logits == jlog).mean())}
    return out


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    for seed in [int(a) for a in argv] or [6, 7, 8, 9, 10]:
        print(json.dumps(readings(seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
