#!/usr/bin/env python3
"""Run chip_smoke.py's phase 6 (yi-9b serving at full width) of two
source trees on one GPU, in turns: baseline, current, current, baseline.

    python3 tools/lm_phase_ab.py BASELINE_DIR

BASELINE_DIR holds another commit's ``chip_smoke.py`` and ``src/``
(unpack it with ``git archive <commit> | tar -x -C build/<dir>``: the
GPU machine has no git). Each run is a process of its own, which imports
``chip_smoke`` from its tree (and through it that tree's
``repro_torch``) and runs ``phase_lm_full``; its summary (serve tok/s,
the decode step's median ms and bound, peak memory) is printed as one
JSON line, then the two trees' numbers side by side. Needs a CUDA GPU.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree):
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != tree:
        raise SystemExit(f"imported {chip_smoke.__file__}, not {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    # as phase 1 leaves them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = chip_smoke.phase_lm_full(smi)
    print("RESULT " + json.dumps(dict(out, smi=smi)), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(os.path.abspath(sys.argv[2]))
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    trees = {"baseline": os.path.abspath(sys.argv[1]), "current": ROOT}
    runs = []
    for name in ("baseline", "current", "current", "baseline"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[name]], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{name} run failed ({proc.returncode})")
        line = [s for s in proc.stdout.splitlines()
                if s.startswith("RESULT ")][-1]
        runs.append((name, json.loads(line[len("RESULT "):])))
    print(f"phase 6, in turns ({runs[0][1]['smi']}):")
    for key in ("tok_per_s", "step_ms", "bound_ms", "peak_gb"):
        cells = ", ".join(f"{name} {r[key]:.3f}" for name, r in runs)
        print(f"  {key}: {cells}")


if __name__ == "__main__":
    main()
