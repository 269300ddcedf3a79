"""Elementwise-op throughput microbenchmark on a CUDA card.

Counterpart of `scripts/op_microbench.py` (the JAX package's TPU
microbench, :37 `make_bench.run`): a dependent chain `acc = op(acc, y)`
of N = 512 steps over a [256, 1024] array, in ten (op, dtype) cases, and
the rate 256 * 1024 * steps / time in Top/s. The chain runs in the
hand-written kernel `csrc/op_chain.cu` (`op_chain`, with `.launches`);
`op_chain_plain` is its plain version, a loop of torch ops.

Run: python -m colormipsearch_torch.scripts.op_microbench --device cuda

Each case is checked against its plain version at N steps and at
TIMED_STEPS, and timed at TIMED_STEPS and 2 * TIMED_STEPS. On an H100 the
134M ops of an N-step chain take less time than one launch, so the rate
is taken at TIMED_STEPS = 64 * N. A ratio of the 2 * TIMED_STEPS and
TIMED_STEPS times outside 1.8-2.2 means the chain was not run step by
step, and the case fails. A case whose kernel cannot be built or
launched prints "unsupported"; any failed case makes the exit code 1.

ptxas may merge two dependent steps into one three-input instruction, so
beside the rate in steps it prints the SASS instructions per step of
each case's main loop (`loop_instructions`, from cuobjdump -sass of the
built kernel) and the instruction rate they give.
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cds import kernels
from ..device import resolve_device

H, W = 256, 1024   # the reference's array
N = 512            # chain length
TIMED_STEPS = 64 * N  # chain length of the rate: long enough for the card
RATIO_BAND = (1.8, 2.2)  # t(2S) / t(S) of a chain run step by step


def _add(a, b):
    return a + b


def _mul(a, b):
    return a * b


def _mul_1000(a, _):
    return a * 1000


def _cmp_sel(a, b):
    return torch.where(a > b, a, b)


def _mul_u16(a, b):
    # torch's uint16 lacks mul on some builds: the chain is carried in
    # int64 (the CASES entry, so the product cannot overflow) and masked
    # to 16 bits after every step
    return (a * b) & 0xFFFF


# (name, element dtype, plain op, dtype the plain chain is carried in),
# in the order of the reference's main() (:71-82) and of op_chain.cu's
# Case enum. bf16: the product of two bf16 values is exact in f32, so
# torch's f32 product rounded to bf16 equals the kernel's mul.rn.bf16.
CASES = (
    ("add i32", torch.int32, _add, torch.int32),
    ("mul i32", torch.int32, _mul, torch.int32),
    ("mul i32 by const 1000", torch.int32, _mul_1000, torch.int32),
    ("add i16", torch.int16, _add, torch.int16),
    ("mul i16", torch.int16, _mul, torch.int16),
    ("mul u16", torch.uint16, _mul_u16, torch.int64),
    ("add u8", torch.uint8, _add, torch.uint8),
    ("mul f32", torch.float32, _mul, torch.float32),
    ("mul bf16", torch.bfloat16, _mul, torch.bfloat16),
    ("cmp+sel i32", torch.int32, _cmp_sel, torch.int32),
)
CASE_NAMES = tuple(c[0] for c in CASES)


def _case(name: str):
    try:
        i = CASE_NAMES.index(name)
    except ValueError:
        raise ValueError(f"unknown case {name!r}; cases: {CASE_NAMES}")
    return (i,) + CASES[i][1:]


def case_inputs(name: str, shape=(H, W), seed: int = 0, device="cpu"):
    """x and y of a case: integers 1..99 from a numpy seed, as the
    reference's measure() (:47-50), in the case's dtype."""
    _, dtype, _, _ = _case(name)
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 100, size=shape)
    y = rng.integers(1, 100, size=shape)
    return tuple(torch.from_numpy(a).to(dtype).to(device) for a in (x, y))


def op_chain_plain(name: str, x: torch.Tensor, y: torch.Tensor,
                   steps: int = N) -> torch.Tensor:
    """Plain version: a loop of `steps` torch ops acc = op(acc, y)."""
    _, dtype, op, carry = _case(name)
    acc, yc = x.to(carry), y.to(carry)
    for _ in range(steps):
        acc = op(acc, yc)
    return acc.to(dtype)


def op_chain(name: str, x: torch.Tensor, y: torch.Tensor,
             steps: int = N) -> torch.Tensor:
    """The chain of `name` over x and y (see op_chain_plain).

    CPU tensors run the plain version. CUDA tensors launch the Hopper
    kernel (built at first use) or raise; there is no fallback."""
    kinds = {x.device.type, y.device.type}
    if kinds == {"cpu"}:
        return op_chain_plain(name, x, y, steps)
    if kinds != {"cuda"}:
        raise ValueError(f"x and y on {sorted(kinds)}: expected both on one "
                         "CUDA device or both on the CPU")
    case, dtype, _, _ = _case(name)
    lib = kernels.load_library("op_chain").lib
    for t in (x, y):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype}, got "
                             f"{t.dtype}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("x and y differ in shape or device")
    if steps < 0 or x.numel() >= 2 ** 31:
        raise ValueError("steps must be >= 0 and x hold < 2**31 elements")
    out = torch.empty_like(x)
    dev = x.device
    rc = lib.cms_op_chain(case, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          x.numel(), steps,
                          torch.cuda.current_stream(dev).cuda_stream,
                          dev.index)
    if rc != 0:
        raise RuntimeError(f"op_chain kernel launch failed ({name}): "
                           f"cudaError {rc}")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when equal, else the largest |got - want| where they differ."""
    if torch.equal(got, want):
        return 0.0
    diff = got.to(torch.float64) - want.to(torch.float64)
    return float(diff[got != want].abs().max())


def measure(name: str, device, reps: int = 5, rounds: int = 3) -> dict:
    """One case on the card: the kernel against its plain version at N
    and at S = TIMED_STEPS steps; the kernel's time at S and 2S (each the
    least of `rounds` means of `reps` calls, S and 2S in turns, so that a
    passing change of clock does not fall on one of them) and the plain
    version's at S; the rate 256 * 1024 * S / t(S)."""
    x, y = case_inputs(name, device=device)
    err = max(max_abs_err(op_chain(name, x, y, steps),
                          op_chain_plain(name, x, y, steps))
              for steps in (N, TIMED_STEPS))
    ms, ms2 = (min(ts) for ts in zip(*(
        [cuda_ms(lambda: op_chain(name, x, y, k * TIMED_STEPS), reps)
         for k in (1, 2)] for _ in range(rounds))))
    plain_ms = cuda_ms(lambda: op_chain_plain(name, x, y, TIMED_STEPS), 1)
    return {"name": name, "max_abs_err": err, "ms": ms, "ms_2s": ms2,
            "ratio_2s": ms2 / ms, "plain_ms": plain_ms,
            "tops": H * W * TIMED_STEPS / (ms * 1e-3) / 1e12,
            "ok": err == 0 and RATIO_BAND[0] <= ms2 / ms <= RATIO_BAND[1]}


_SASS_INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(\S[^;]*?)\s*;",
                        re.MULTILINE)
_SASS_BRA = re.compile(r"\bBRA\s+0x([0-9a-f]+)")


def loop_instructions(sass: str) -> Dict[int, Counter]:
    """{op case: mnemonic counts of its kernel's main loop}, read from
    cuobjdump -sass of the op_chain library: in each op_chain_kernel<C>,
    the longest body of a backward branch (op_chain.cu's main loop of
    UNROLL steps of each chain, with its loop control)."""
    out: Dict[int, Counter] = {}
    for func in sass.split("Function : ")[1:]:
        m = re.search(r"op_chain_kernelILi(\d+)E", func.split("\n", 1)[0])
        if m is None:
            continue
        insns = [(int(a, 16), t) for a, t in _SASS_INSN.findall(func)]
        best: list = []
        for addr, text in insns:
            bra = _SASS_BRA.search(text)
            if bra and int(bra.group(1), 16) < addr:
                tgt = int(bra.group(1), 16)
                body = [t for a, t in insns if tgt <= a <= addr]
                best = max(best, body, key=len)
        out[int(m.group(1))] = Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in best)
    return out


def instructions_per_step() -> Dict[str, tuple]:
    """{case name: (SASS instructions per step, mnemonic counts)} of the
    built kernel's main loops, loop control included."""
    lib = kernels.load_library("op_chain")
    steps = lib.lib.cms_op_chain_loop_steps()
    loops = loop_instructions(kernels.sass("op_chain"))
    return {name: (sum(loops[i].values()) / steps, loops[i])
            for i, name in enumerate(CASE_NAMES) if i in loops}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card to measure: cuda or cuda:N")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("the microbench times the CUDA kernel: give "
                         "--device cuda")
    print(f"{torch.cuda.get_device_name(device)}: [{H}, {W}], chains of "
          f"{N} steps (checked) and {TIMED_STEPS} (timed)", flush=True)
    failed = 0
    loops = None  # instructions_per_step, read once the library is built
    for name in CASE_NAMES:
        try:
            r = measure(name, device)
        except RuntimeError as e:  # the kernel cannot be built or launched
            print(f"{name:24s} unsupported ({str(e).splitlines()[0][:80]})",
                  flush=True)
            failed += 1
            continue
        failed += not r["ok"]
        print(f"{name:24s} {r['tops']:8.3f} Top/s  ({r['ms']:.4f} ms; "
              f"2S/S {r['ratio_2s']:.3f}; plain {r['plain_ms']:.3f} ms; "
              f"max |kernel - plain| {r['max_abs_err']})"
              + ("" if r["ok"] else "  FAILED"), flush=True)
        if loops is None:
            loops = instructions_per_step()
        if name not in loops:
            print(f"{'':24s} SASS main loop not found  FAILED", flush=True)
            failed += 1
            continue
        per_step, mnemonics = loops[name]
        print(f"{'':24s} SASS {per_step:.3f} instructions per step = "
              f"{r['tops'] * per_step:.3f} Tinst/s; main loop "
              + ", ".join(f"{k} x{v}" for k, v in mnemonics.most_common(4)),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
