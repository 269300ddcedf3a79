"""The port's op microbench (colormipsearch_torch.scripts.op_microbench):
its plain chain equals a jax.lax.fori_loop of the same jnp op for all ten
(op, dtype) cases of the JAX package's scripts/op_microbench.py (not
imported: it sets a compilation-cache directory when imported), and the
wrapper runs the plain version on CPU tensors. Exact equality: integer
chains wrap, float chains round the same way at every step. Also the
SASS reading (kernels.sass_loops) and the peak-rate bound of an
instruction mix (kernels.issue_bound_s) on synthetic listings."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from colormipsearch_torch.cds import kernels  # noqa: E402
from colormipsearch_torch.scripts import op_microbench as ob  # noqa: E402

SHAPE = (4, 96)

# the reference's ten cases (scripts/op_microbench.py:71-82)
REF_CASES = {
    "add i32": (lambda a, b: a + b, np.int32),
    "mul i32": (lambda a, b: a * b, np.int32),
    "mul i32 by const 1000": (lambda a, b: a * 1000, np.int32),
    "add i16": (lambda a, b: a + b, np.int16),
    "mul i16": (lambda a, b: a * b, np.int16),
    "mul u16": (lambda a, b: a * b, np.uint16),
    "add u8": (lambda a, b: a + b, np.uint8),
    "mul f32": (lambda a, b: a * b, np.float32),
    "mul bf16": (lambda a, b: a * b, jnp.bfloat16),
    "cmp+sel i32": (lambda a, b: jnp.where(a > b, a, b), np.int32),
}


def test_cases_follow_the_reference():
    assert ob.CASE_NAMES == tuple(REF_CASES)
    assert (ob.H, ob.W, ob.N) == (256, 1024, 512)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_plain_chain_matches_jax(name):
    op, dtype = REF_CASES[name]
    x, y = ob.case_inputs(name, SHAPE, seed=7)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(dtype)
    yj = jnp.asarray(y.to(torch.float32).numpy()).astype(dtype)
    want = jax.jit(lambda a, b: jax.lax.fori_loop(
        0, ob.N, lambda i, acc: op(acc, b), a))(xj, yj)
    got = ob.op_chain_plain(name, x, y)
    assert got.dtype == x.dtype and got.shape == SHAPE
    np.testing.assert_array_equal(got.to(torch.float64).numpy(),
                                  np.asarray(want).astype(np.float64))
    # the wrapper runs the plain version for CPU tensors; no launch
    before = ob.op_chain.launches
    assert torch.equal(ob.op_chain(name, x, y), got)
    assert ob.op_chain.launches == before


def test_chain_length_is_honoured():
    """The N/2N timing rests on the step count: 2N steps of add equal
    N steps applied twice."""
    x, y = ob.case_inputs("add i32", SHAPE)
    twice = ob.op_chain_plain("add i32", ob.op_chain_plain("add i32", x, y),
                              y)
    assert torch.equal(ob.op_chain_plain("add i32", x, y, 2 * ob.N), twice)
    assert torch.equal(ob.op_chain_plain("add i32", x, y, 0), x)


def _sass():
    """A cuobjdump -sass listing in the shape op_chain's library gives:
    a main loop of four steps merged in two IADD3, a remainder loop, and
    the trailing self-branch after EXIT; one function of another name."""
    body = [("0000", "LDC R1, c[0x0][0x28]"), ("0010", "VIADD R8, R8, -0x4"),
            ("0020", "IADD3 R7, R7, R12, R12"),
            ("0030", "IADD3 R7, R7, R12, R12"),
            ("0040", "ISETP.NE.AND P5, PT, R8, RZ, PT"),
            ("0050", "@P5 BRA 0x10"), ("0060", "IADD3 R7, R7, R12, RZ"),
            ("0070", "@!P4 BRA 0x60"), ("0080", "EXIT"), ("0090", "BRA 0x90")]
    func = "".join(f"        /*{addr}*/{' ' * 19}{text} ;   /* 0x000fe400 */\n"
                   f"{' ' * 80}/* 0x000fe4 */\n" for addr, text in body)
    return ("\tcode for sm_90a\n\t\tFunction : _ZN4cms5otherEv\n" + func
            + "\t\tFunction : _ZN44_GLOBAL__N_15op_chain_kernelILi3EEEvPKNS"
            "_2OpIXT_EE1TES5_PS3_iii\n" + func)


def test_loop_instructions_reads_the_main_loop():
    """The longest backward branch's body of each op_chain_kernel<C>."""
    loops = ob.loop_instructions(_sass())
    assert loops == {3: {"VIADD": 1, "IADD3": 2, "ISETP.NE.AND": 1,
                         "BRA": 1}}
    assert ob.loop_instructions("no functions here") == {}


def test_sass_loops_and_the_innermost():
    """Every backward branch is a loop; the innermost hold no other."""
    loops = kernels.sass_loops(_sass())
    assert len(loops) == 2 and "_ZN4cms5otherEv" in loops
    assert any("op_chain_kernelILi3E" in n for n in loops)
    spans = [(lp.start, lp.end) for lp in loops["_ZN4cms5otherEv"]]
    assert spans == [(0x10, 0x50), (0x60, 0x70)]
    nested = kernels.SassLoop(0x0, 0x80, Counter())
    inner = kernels.innermost_loops(loops["_ZN4cms5otherEv"] + [nested])
    assert [(lp.start, lp.end) for lp in inner] == spans


@pytest.mark.parametrize("mix,pipe,clocks", [
    # add i32: three-input adds on the ALU pipe (64 lanes per clock)
    ({"IADD3": 128, "VIADD": 1, "UIADD3": 1, "ISETP.GT.AND": 1}, "alu",
     130 / 64),
    # mul f32: the two FMA pipes take 128 lanes, so issue sets the bound
    ({"FMUL": 256, "IADD3": 1, "ISETP.GT.AND": 1, "UIADD3": 1}, "issue",
     259 / 128),
    # mul bf16: packed HFMA2/HMUL2 on the FMA pipes, issue-bound
    ({"HFMA2.MMA.BF16_V2": 64, "HMUL2.BF16_V2": 64, "PRMT": 8,
      "UIADD3": 1}, "issue", 137 / 128),
    # mul i32: IMAD on the heavy FMA pipe only (64)
    ({"IMAD": 256, "IADD3": 1, "UIADD3": 1, "ISETP.GT.AND": 1}, "imad",
     256 / 64),
])
def test_issue_bound_takes_the_busiest_pipe(mix, pipe, clocks):
    seconds, got = kernels.issue_bound_s(Counter(mix), 1e9)
    assert got == pipe
    assert seconds == pytest.approx(1e9 * clocks / (132 * 1.98e9))


def test_microbench_needs_a_card(monkeypatch):
    with pytest.raises(SystemExit, match="--device cuda"):
        ob.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ob.main(["--device", "cuda"])
    with pytest.raises(ValueError, match="unknown case"):
        ob.op_chain_plain("div i8", *ob.case_inputs("add i32", SHAPE))
