#!/usr/bin/env python
"""Generate tests/dataset_costs.json: converged centralized costs for the
bundled reference datasets (VERDICT r2 #7 — committed regression anchors
asserted by tests/test_datasets_parity.py at rtol 1e-6).

Runs EXACTLY the test module's solve (tests.test_datasets_parity.solve_case)
so the anchors are reproducible by the suite. Costs are SELF-recorded from
the deterministic CPU f64 pipeline; sphere2500 additionally carries the
externally-known SE-Sync global optimum 1687.0058 (asserted separately in
the test). Cross-checking the other datasets against published optima
requires network access (and exactly matching kappa/tau conventions) — not
available in this environment.

Run on CPU: JAX_PLATFORMS=cpu python scripts/gen_parity_table.py
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)


def main():
    from tests.anchor_meta import numerics_fingerprint
    from tests.test_datasets_parity import CASES, solve_case

    out = {"_meta": {"numerics_sha256": numerics_fingerprint()}}
    for name, _known, tol in CASES:
        t0 = time.perf_counter()
        X, stats, d = solve_case(name, tol)
        rec = {
            "cost": 2 * float(stats.f_opt),
            "gradnorm": float(stats.gnorm_opt),
            "gradnorm_init": float(stats.gnorm_init),
            "iterations": int(stats.iterations),
            "seconds": round(time.perf_counter() - t0, 1),
        }
        out[name] = rec
        print(f"{name}: cost={rec['cost']:.10g} gradnorm={rec['gradnorm']:.3e} "
              f"iters={rec['iterations']} ({rec['seconds']}s)", flush=True)
    path = os.path.join(_REPO, "tests", "dataset_costs.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
