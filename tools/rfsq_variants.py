"""Build variants of the fused ResidualFSQ eval kernel (K9) and measure them
on one CUDA card, to settle its design choices in one run:

  - tokens a thread (two in the source; one and four here);
  - the launch bounds' minimum of one block an SM (the source's) or none;
  - the IEEE route's dim loops unrolled or not (the source's: not).

Each variant is vqtpu_torch/kernels/csrc/residual_fsq_fused.cu with one or
two lines replaced, built with the package's nvcc flags into
build/rfsq_variants/, all builds started together. For each variant one
JSON line gives the fixed instantiations that spill (ptxas), the main
instantiation's registers, its time at the main shape (4,194,304 tokens,
levels (8, 5, 5, 5), q = 8; CUDA events, 100 calls, twice, the variants in
turn and then in reverse) and whether its output equals the plain version
bit for bit.

    python tools/rfsq_variants.py

Needs one CUDA card and nvcc; runs from the root of a checkout.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import vqtpu_torch.kernels.residual_fsq_fused as tk  # noqa: E402
from vqtpu_torch import ResidualFSQ  # noqa: E402
from vqtpu_torch.kernels import _build  # noqa: E402

TOKENS = '  constexpr int T = 2;'
MIN_BLOCKS = ('__launch_bounds__(kThreads, 1)\nresidual_fsq_eval_kernel',
              '__launch_bounds__(kThreads)\nresidual_fsq_eval_kernel')
IEEE_LOOPS = [
    ('#pragma unroll 1\n  for (int j = 0; j < d; ++j) {\n    const float c = __ldg(clamp + j);',
     '#pragma unroll\n  for (int j = 0; j < d; ++j) {\n    const float c = __ldg(clamp + j);'),
    ('#pragma unroll 1\n    for (int j = 0; j < d; ++j) {\n      const float s = __ldg(scales + i * d + j);',
     '#pragma unroll\n    for (int j = 0; j < d; ++j) {\n      const float s = __ldg(scales + i * d + j);'),
]
VARIANTS = {
    'source': [],
    'tokens_1': [(TOKENS, '  constexpr int T = 1;')],
    'tokens_4': [(TOKENS, '  constexpr int T = 4;')],
    'no_min_blocks': [MIN_BLOCKS],
    'ieee_dims_unrolled': IEEE_LOOPS,
    'ieee_dims_unrolled_no_min_blocks': IEEE_LOOPS + [MIN_BLOCKS],
}


def build_all(out: Path) -> dict[str, str]:
    source = (_build.CSRC / 'residual_fsq_fused.cu').read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'{name}: the source no longer holds {old!r}')
            text = text.replace(old, new)
        (out / f'{name}.cu').write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(out / f'{name}.so'), str(out / f'{name}.cu')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc exited {proc.returncode}\n{logs[name]}')
    return logs


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = lib.vqtpu_residual_fsq_eval_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print('rfsq_variants: no CUDA device; this script needs one', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / 'build' / 'rfsq_variants'
    t0 = time.perf_counter()
    logs = build_all(out)
    print(json.dumps({'build_s': time.perf_counter() - t0, 'variants': list(VARIANTS)}), flush=True)

    device = torch.device('cuda')
    levels, q, lead = cs.RFSQ_MAIN
    torch.manual_seed(80)
    m = ResidualFSQ(dim=len(levels), levels=list(levels), num_quantizers=q, device=device).eval()
    x = cs.rfsq_input(levels, lead, device, 81).reshape(-1, len(levels))
    kw = dict(levels=levels, clamp=m.soft_clamp_input_value, num_quantizers=q)
    want = tk.fused_residual_fsq_eval_plain(x, m._scales(), **kw)
    libs = {name: load(out / f'{name}.so') for name in VARIANTS}

    def call():
        return tk.fused_residual_fsq_eval(x, m._scales(), **kw)

    times: dict[str, list[float]] = {name: [] for name in VARIANTS}
    equal: dict[str, bool] = {}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            # the wrapper loads its library through _build's cache: put the variant there
            _build._libraries['residual_fsq_fused'] = libs[name]
            got = call()
            equal[name] = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            times[name].append(cs.cuda_ms(call, 100))
    for name in VARIANTS:
        entries = cs.ptxas_entries(logs[name], 'residual_fsq_eval_kernel')['entries']
        fixed = {k: v for k, v in entries.items() if 'ILi0ELi0E' not in k}
        spilling = {k[k.index('kernelILi') + 6:k.index('EEEv')]: v['spill_bytes']
                    for k, v in fixed.items() if v.get('spill_bytes')}
        main_entry = next(v for k, v in fixed.items() if 'ILi4ELi8E' in k)
        print(json.dumps(dict(variant=name, card=smi, ms=times[name], bit_identical=equal[name],
                              main_registers=main_entry['registers'], main_spill_bytes=main_entry['spill_bytes'],
                              fixed_instantiations=len(fixed), spilling=len(spilling),
                              most_spill_bytes=max(spilling.values(), default=0), spilling_entries=spilling)),
              flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
