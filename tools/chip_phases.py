#!/usr/bin/env python3
"""Run chosen phases of chip_smoke.py alone on the card, each timed.

    python3 tools/chip_phases.py tp_vq_train tp_vq_eval examples_distributed

Builds the kernels first (chip_smoke.py's phase 1), then runs each named
phase that takes no argument, in the order given: `phase_<name>` of
chip_smoke.py, or a function of that name (`examples_distributed`). Each
phase prints its own JSON lines; then one line `{"phase_s": {name:
seconds}}`. Needs one CUDA card and nvcc, as chip_smoke.py does; run it
from the root of a checkout.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(names) -> int:
    phases = [getattr(cs, f'phase_{name}', None) or getattr(cs, name) for name in names]
    cs.set_backends()
    cs.use_build_caches()
    seconds = {}
    t0 = time.perf_counter()
    cs.phase_device()
    seconds['device'] = time.perf_counter() - t0
    for name, phase in zip(names, phases):
        t0 = time.perf_counter()
        phase()
        seconds[name] = time.perf_counter() - t0
    print(json.dumps(dict(phase_s=seconds)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
