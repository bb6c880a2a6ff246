"""The lane programs of the lane-group BLS kernels, rendered as tables.

A lane group (csrc/bls/coop.cuh ``lg_step``) is G threads of one warp
that serve one lane (one point, one square root). The lane's field values
live in the block's shared memory as Fp slots; a *step* is

1. its independent Fp products, spread over the group's threads: product
   j of the step on thread j mod G, each operand a slot or the sum or
   difference of two slots (a Karatsuba pre-addition), the product
   optionally doubled, stored to a slot;
2. then up to three stages of linear outputs, each a slot set to a small
   integer combination of up to eight slots (the formula's additions and
   the Karatsuba recombinations), again spread over the threads: a list
   of at most ``LIN_OPS`` operations on an accumulator (add a slot,
   subtract a slot, double), Horner over the coefficients' bits, which
   every thread runs with the same instructions;

with a ``__syncwarp`` of the group after each phase. A kernel walks its
lane's program one step at a time (which step comes next is the kernel's
own control: a scalar bit, an exponent bit, a branch of the addition), so
every thread runs the multiply at one site of the kernel, on the operands
its table entry names.

This module holds the programs (the Jacobian doubling, the mixed and the
general addition over Fp and Fp2, psi, the Jacobian equality, the square
root's steps), written as the formulas of csrc/bls/curve.cuh and fp.cuh:
the same field values, canonically. It assigns the slots (a value's slot
is reused once its last reader's phase has passed, never within a
phase), checks that no phase reads what it writes, and renders
``csrc/bls/lane_prog.cuh``; tests/test_torch_coop_host.py checks that the
file equals ``render()`` and runs the programs with Python integers
(``run_step``) against the plain formulas. Regenerate with

    python -m lighthouse_tpu_torch.ops.bls_lane > \\
        lighthouse_tpu_torch/csrc/bls/lane_prog.cuh
"""
from __future__ import annotations

#: the most terms of a linear output, |c| < 16 each
LIN_TERMS = 8
#: the most operations of a linear output's list (two 64-bit words: the
#: slot written (6 bits) and the count (4), then 8 bits an operation: a
#: slot (6 bits), bit 6 subtract, bit 7 double the accumulator)
LIN_OPS = 14
OP_SUB, OP_DBL = 64, 128
#: the most linear stages of a step
LIN_STAGES = 3
_NEVER = 1 << 30


class Val:
    """One Fp value of a lane: a product, a linear output or the content
    of a fixed slot at a program's start."""

    def __init__(self, block: "Block", k: int):
        self.block, self.k = block, k

    @property
    def slot(self) -> int:
        return self.block.slot + self.k

    def __repr__(self):
        return f"{self.block.name}[{self.k}]"


class Block:
    """Values that share consecutive slots: an element materialized at
    once, a product's raw outputs, or a fixed slot range."""

    def __init__(self, name: str, size: int, defined: int,
                 slot: int | None = None):
        self.name, self.size, self.defined = name, size, defined
        self.slot = slot
        self.last = -1
        self.vals = [Val(self, k) for k in range(size)]


def _form(v: Val) -> dict:
    return {v: 1}


def _comb(a: dict, b: dict, k: int = 1) -> dict:
    r = dict(a)
    for v, c in b.items():
        r[v] = r.get(v, 0) + k * c
        if r[v] == 0:
            del r[v]
    return r


def add(a, b):
    return tuple(_comb(x, y) for x, y in zip(a, b))


def sub(a, b):
    return tuple(_comb(x, y, -1) for x, y in zip(a, b))


def scale(a, k: int):
    return tuple({v: k * c for v, c in x.items()} for x in a)


def neg(a):
    return scale(a, -1)


def conj(a):
    return (a[0], scale((a[1],), -1)[0])


class Program:
    """A lane program of ``layout``: its steps in order."""

    def __init__(self, layout: "Layout", name: str):
        self.layout, self.name = layout, name
        self.steps: list[Step] = []
        self.blocks: list[Block] = []
        self.exports: dict[str, Block] = {}
        # the value each fixed slot holds now
        self.cur = {s: Val(layout.fixed_block, s)
                    for s in range(layout.nfixed)}
        self.fixed_last = {s: -1 for s in range(layout.nfixed)}
        self.fixed_def = {s: -1 for s in range(layout.nfixed)}

    def elem(self, name: str):
        """The current value of fixed range ``name`` as an element."""
        base, size = self.layout.fixed[name]
        return tuple(_form(self.cur[base + i]) for i in range(size))

    def step(self) -> "Step":
        s = Step(self, len(self.steps))
        self.steps.append(s)
        return s

    def export(self, name: str, elem) -> None:
        """Keep ``elem`` (one materialized block) to the program's end and
        name its first slot for the kernel's control code."""
        vals = [next(iter(f)) for f in elem]
        block = vals[0].block
        assert all(len(f) == 1 and f[v] == 1 for f, v in zip(elem, vals))
        assert [v.k for v in vals] == list(range(block.size)), name
        block.last = _NEVER
        self.exports[name] = block

    def use(self, v: Val, phase: int) -> None:
        if v.block is self.layout.fixed_block:
            assert self.cur[v.k] is v, f"{self.name}: stale {v}"
            assert self.fixed_def[v.k] < phase, f"{self.name}: {v} read early"
            self.fixed_last[v.k] = max(self.fixed_last[v.k], phase)
        else:
            assert v.block.defined < phase, f"{self.name}: {v} read early"
            v.block.last = max(v.block.last, phase)


class Step:
    def __init__(self, prog: Program, index: int):
        self.prog, self.index = prog, index
        self.jobs = []                       # (dst, x, y, double)
        self.lins = [[] for _ in range(LIN_STAGES)]

    @property
    def degree(self) -> int:
        return self.prog.layout.degree

    def _new(self, name, size, phase) -> Block:
        b = Block(name, size, phase)
        self.prog.blocks.append(b)
        return b

    def _operand(self, f: dict, phase: int) -> tuple:
        """(a, b, sign): a slot, plus or minus a second (b None: alone)."""
        terms = sorted(f.items(), key=lambda t: -t[1])
        assert 1 <= len(terms) <= 2 and terms[0][1] == 1 and all(
            abs(c) == 1 for _, c in terms), f"operand {f} needs a slot"
        for v, _ in terms:
            self.prog.use(v, phase)
        if len(terms) == 1:
            return (terms[0][0], None, 1)
        return (terms[0][0], terms[1][0], terms[1][1])

    def _products(self, name, pairs, doubles=None):
        phase = 4 * self.index
        block = self._new(name, len(pairs), phase)
        for i, (x, y) in enumerate(pairs):
            self.jobs.append((block.vals[i], self._operand(x, phase),
                              self._operand(y, phase),
                              bool(doubles and doubles[i])))
        return [_form(v) for v in block.vals]

    def mul(self, a, b, name="mul"):
        """a b: one product (Fp) or three (Fp2, Karatsuba as fp2_mul)."""
        if self.degree == 1:
            return tuple(self._products(name, [(a[0], b[0])]))
        t0, t1, t2 = self._products(name, [
            (a[0], b[0]), (a[1], b[1]),
            (_comb(a[0], a[1]), _comb(b[0], b[1]))])
        return (_comb(t0, t1, -1), _comb(_comb(t2, t0, -1), t1, -1))

    def mulc(self, a, b, name="mulc"):
        """conj(a) b (Fp2): t0 = a0 b0, t1 = a1 b1, t2 = (a0 - a1)(b0 +
        b1); (t0 + t1, t2 - t0 + t1)."""
        t0, t1, t2 = self._products(name, [
            (a[0], b[0]), (a[1], b[1]),
            (_comb(a[0], a[1], -1), _comb(b[0], b[1]))])
        return (_comb(t0, t1), _comb(_comb(t2, t0, -1), t1))

    def sqr(self, a, name="sqr"):
        """a^2: a a (Fp); (a0 + a1)(a0 - a1) and 2 a0 a1 (Fp2, fp2_sqr)."""
        if self.degree == 1:
            return tuple(self._products(name, [(a[0], a[0])]))
        return tuple(self._products(name, [
            (_comb(a[0], a[1]), _comb(a[0], a[1], -1)), (a[0], a[1])],
            doubles=[False, True]))

    def mul_fp(self, pairs, name="mulfp"):
        """Fp products of coefficients, one a pair."""
        return tuple(self._products(name, pairs))

    def _lin_terms(self, f: dict, phase: int) -> list:
        terms = list(f.items())
        assert 1 <= len(terms) <= LIN_TERMS, f"{len(terms)} terms"
        for v, c in terms:
            assert 0 < abs(c) < 16
            self.prog.use(v, phase)
        return terms

    def lin(self, elem, stage: int = 0, name="lin"):
        """Materialize ``elem`` into new slots in linear stage ``stage``."""
        phase = 4 * self.index + 1 + stage
        block = self._new(name, len(elem), phase)
        for v, f in zip(block.vals, elem):
            self.lins[stage].append((v, self._lin_terms(f, phase)))
        return tuple(_form(v) for v in block.vals)

    def out(self, fixed: str, elem, stage: int = 0):
        """Write ``elem`` into fixed range ``fixed`` in linear stage
        ``stage`` (its old values must not be read from this stage on)."""
        phase = 4 * self.index + 1 + stage
        prog = self.prog
        base, size = prog.layout.fixed[fixed]
        assert size == len(elem)
        terms = [self._lin_terms(f, phase) for f in elem]
        for i in range(size):
            s = base + i
            assert prog.fixed_last[s] < phase, (
                f"{prog.name}: {fixed}[{i}] overwritten while read")
            v = Val(prog.layout.fixed_block, s)
            prog.cur[s] = v
            prog.fixed_last[s] = prog.fixed_def[s] = phase
            self.lins[stage].append((v, terms[i]))
        return prog.elem(fixed)


class Layout:
    """The slots of one kernel's lanes: fixed ranges (inputs, outputs,
    constants the kernel loads), then the programs' temporaries."""

    def __init__(self, name: str, degree: int, fixed: list[tuple[str, int]]):
        self.name, self.degree = name, degree
        self.fixed = {}
        n = 0
        for fname, size in fixed:
            self.fixed[fname] = (n, size)
            n += size
        self.nfixed = n
        self.fixed_block = Block("fixed", n, -1, slot=0)
        self.programs: list[Program] = []

    def program(self, name: str) -> Program:
        p = Program(self, name)
        self.programs.append(p)
        return p

    def assign(self) -> int:
        """Slots for every program's blocks; returns the slots a lane."""
        top = self.nfixed
        for p in self.programs:
            busy = []                       # (first, size, last phase)
            for b in sorted(p.blocks, key=lambda b: b.defined):
                if b.last < 0:
                    b.last = b.defined      # never read (kept for a lin)
                busy = [u for u in busy if u[2] >= b.defined]
                s = self.nfixed
                while any(s < f + n and f < s + b.size for f, n, _ in busy):
                    s += 1
                b.slot = s
                busy.append((s, b.size, b.last))
                top = max(top, s + b.size)
        return top


# --------------------------------------------------------------- programs

def _dbl(layout: Layout) -> Program:
    """curve.cuh jac_dbl on ACC in place: 3 steps."""
    p = layout.program("DBL")
    X, Y, Z = p.elem("X"), p.elem("Y"), p.elem("Z")
    s = p.step()
    A, B, YZ = s.sqr(X, "A"), s.sqr(Y, "B"), s.mul(Y, Z, "YZ")
    E = s.lin(scale(A, 3), name="E")
    S = s.lin(add(X, B), name="S")
    s.out("Z", scale(YZ, 2))
    s = p.step()
    C, T, Fv = s.sqr(B, "C"), s.sqr(S, "T"), s.sqr(E, "F")
    D = s.lin(scale(sub(sub(T, A), C), 2), name="D")
    X3 = sub(Fv, scale(D, 2))
    s.out("X", X3, stage=1)
    W = s.lin(sub(D, X3), stage=1, name="W")
    s = p.step()
    EDX = s.mul(E, W, "EDX")
    s.out("Y", sub(EDX, scale(C, 8)))
    return p


def _add(layout: Layout, mixed: bool) -> Program:
    """curve.cuh jac_add(ACC, Q) into RES, exporting H = U2 - U1 and
    DY = S2 - S1 (the kernel's branches read them): 5 steps. Mixed (Q's z
    is one): U1 = X1, S1 = Y1, and Z3 = 2 Z1 H, the same values without
    the products by one. General: zz - Z1Z1 - Z2Z2 taken as 2 Z1 Z2."""
    p = layout.program("MADD" if mixed else "ADD")
    X1, Y1, Z1 = p.elem("X"), p.elem("Y"), p.elem("Z")
    X2, Y2, Z2 = p.elem("QX"), p.elem("QY"), p.elem("QZ")
    s = p.step()
    Z1Z1 = s.sqr(Z1, "Z1Z1")
    if not mixed:
        Z2Z2, Z1Z2 = s.sqr(Z2, "Z2Z2"), s.mul(Z1, Z2, "Z1Z2")
        M = s.lin(Z1Z2, name="M")
    s = p.step()
    U2, z1c = s.mul(X2, Z1Z1, "U2"), s.mul(Z1, Z1Z1, "z1c")
    if mixed:
        U1 = X1
    else:
        U1r, z2c = s.mul(X1, Z2Z2, "U1"), s.mul(Z2, Z2Z2, "z2c")
        U1, z2c = s.lin(U1r, name="U1m"), s.lin(z2c, name="z2cm")
    H = s.lin(sub(U2, U1 if mixed else U1r), name="H")
    z1c = s.lin(z1c, name="z1cm")
    s = p.step()
    S2, HH = s.mul(Y2, z1c, "S2"), s.sqr(H, "HH")
    if mixed:
        S1, ZH = Y1, s.mul(Z1, H, "ZH")
    else:
        S1, ZH = s.mul(Y1, z2c, "S1"), s.mul(M, H, "ZH")
    DY = s.lin(sub(S2, S1), name="DY")
    if not mixed:
        S1 = s.lin(S1, name="S1m")
    I = s.lin(scale(HH, 4), name="I")
    s.out("RZ", scale(ZH, 2))
    s = p.step()
    J, V, DD = s.mul(H, I, "J"), s.mul(U1, I, "V"), s.sqr(DY, "DD")
    X3 = sub(sub(scale(DD, 4), J), scale(V, 2))
    s.out("RX", X3)
    Jm = s.lin(J, name="Jm")
    W = s.lin(sub(V, X3), name="W")
    s = p.step()
    P1, P2 = s.mul(DY, W, "P1"), s.mul(S1, Jm, "P2")
    s.out("RY", sub(scale(P1, 2), scale(P2, 2)))
    p.export("H", H)
    p.export("DY", DY)
    return p


def _curve(layout: Layout) -> dict:
    return {"DBL": _dbl(layout), "MADD": _add(layout, True),
            "ADD": _add(layout, False)}


def _scalar_layout(name: str, degree: int, extra=()) -> Layout:
    return Layout(name, degree, [(c, degree) for c in (
        "X", "Y", "Z", "QX", "QY", "QZ", "RX", "RY", "RZ")] + list(extra))


def rlc(degree: int) -> Layout:
    """rlc_scale.cu: [b]Q over Fp (1) or Fp2 (2)."""
    layout = _scalar_layout(f"RLC{degree}", degree)
    _curve(layout)
    return layout


def subgroup() -> Layout:
    """g2_intake.cu mode 1: psi(Q), [|u|]Q, the Jacobian equality with
    [u]Q (its y negated)."""
    layout = _scalar_layout("SUB", 2, [("PX", 2), ("PY", 2), ("PZ", 2),
                                       ("CX", 2), ("CY", 2)])
    p = layout.program("PSI")
    s = p.step()
    s.out("PX", s.mulc(p.elem("QX"), p.elem("CX")))
    s.out("PY", s.mulc(p.elem("QY"), p.elem("CY")))
    s.out("PZ", conj(p.elem("QZ")))
    _curve(layout)
    p = layout.program("EQ")
    X1, Y1, Z1 = p.elem("PX"), p.elem("PY"), p.elem("PZ")
    X2, Y2, Z2 = p.elem("X"), p.elem("Y"), p.elem("Z")
    s = p.step()
    z1s, z2s = s.sqr(Z1, "z1s"), s.sqr(Z2, "z2s")
    s = p.step()
    A, B = s.mul(X1, z2s, "A"), s.mul(X2, z1s, "B")
    T1, T2 = s.mul(z2s, Z2, "T1"), s.mul(z1s, Z1, "T2")
    p.export("EA", s.lin(A, name="EA"))
    p.export("EB", s.lin(B, name="EB"))
    T1, T2 = s.lin(T1, name="T1m"), s.lin(T2, name="T2m")
    s = p.step()
    A2, B2 = s.mul(Y1, T1, "A2"), s.mul(Y2, T2, "B2")
    p.export("EA2", s.lin(A2, name="EA2"))
    p.export("EB2", s.lin(neg(B2), name="EB2"))
    return layout


def decompress() -> Layout:
    """g2_intake.cu mode 0: rhs = x^3 + b, then fp2_sqrt's chain with the
    powers walked from the bottom bit (POW_* steps over ACC and BASE)."""
    layout = Layout("DEC", 2, [(c, 2) for c in (
        "X", "RHS", "BASE", "ACC", "X0", "IX0", "OTHER", "Y", "B",
        "ONE")] + [("INT1", 1), ("YI", 2)])
    p = layout.program("CUBE")
    s = p.step()
    X2 = s.sqr(p.elem("X"), "X2")
    s = p.step()
    rhs = add(s.mul(X2, p.elem("X"), "X3"), p.elem("B"))
    s.out("RHS", rhs)
    s.out("BASE", rhs)
    # the power's steps: a bit below the top squares the base and, where
    # set, takes it into ACC (copied on the first set bit); the top bit
    # multiplies alone
    for name, take, square in (("POW_SQ", None, True),
                               ("POW_CPYSQ", "copy", True),
                               ("POW_MULSQ", "mul", True),
                               ("POW_MUL", "mul", False),
                               ("POW_CPY", "copy", False)):
        p = layout.program(name)
        s = p.step()
        base, acc = p.elem("BASE"), p.elem("ACC")
        if take == "mul":
            s.out("ACC", s.mul(acc, base, "AB"))
        if square:
            sq = s.sqr(base, "BB")
        if take == "copy":
            s.out("ACC", base)
        if square:
            s.out("BASE", sq, stage=1 if take == "copy" else 0)
    p = layout.program("X0")
    s = p.step()
    s.out("X0", s.mul(p.elem("ACC"), p.elem("RHS"), "X0"))
    p = layout.program("ALPHA")
    s = p.step()
    x0 = p.elem("X0")
    alpha = s.lin(s.mul(p.elem("ACC"), x0, "AL"), name="ALPHA")
    p.export("ALPHA", alpha)
    s.out("BASE", add(alpha, p.elem("ONE")), stage=1)
    s.out("IX0", (scale((x0[1],), -1)[0], x0[0]))
    p = layout.program("OTHER")
    s = p.step()
    s.out("OTHER", s.mul(p.elem("ACC"), p.elem("X0"), "OT"))
    p = layout.program("Y2")
    s = p.step()
    p.export("Y2", s.lin(s.sqr(p.elem("Y"), "YY"), name="Y2"))
    p = layout.program("INT")
    s = p.step()
    y, one = p.elem("Y"), p.elem("INT1")
    s.out("YI", s.mul_fp([(y[0], one[0]), (y[1], one[0])], "YI"))
    return layout


def layouts() -> list[Layout]:
    return [rlc(1), rlc(2), subgroup(), decompress()]


# ---------------------------------------------------------------- render

def lin_ops(terms) -> list[int]:
    """A linear output's operations in ``lg_lin`` (from an accumulator of
    zero): over the coefficients' bits from the top, a doubling between
    bits and the addition or subtraction of each term whose |c| has the
    bit."""
    top = max(abs(c).bit_length() for _, c in terms) - 1
    ops = []
    for b in range(top, -1, -1):
        if b < top:
            ops.append(OP_DBL)
        ops += [v.slot | (OP_SUB if c < 0 else 0)
                for v, c in terms if (abs(c) >> b) & 1]
    assert len(ops) <= LIN_OPS
    return ops


def _job_word(dst: Val, x, y, dbl: bool) -> int:
    def operand(o, shift):
        a, b, sign = o
        flags = 0 if b is None else (1 | (2 if sign < 0 else 0))
        return (a.slot | ((0 if b is None else b.slot) << 8),
                flags << shift)
    xw, xf = operand(x, 0)
    yw, yf = operand(y, 2)
    return (dst.slot | (xw << 8) | (yw << 24)
            | ((xf | yf | (16 if dbl else 0)) << 40))


def _lin_words(dst: Val, terms) -> tuple[int, int]:
    ops = lin_ops(terms)
    w0 = dst.slot | (len(ops) << 6)
    for i, op in enumerate(ops[:6]):
        w0 |= op << (10 + 8 * i)
    w1 = 0
    for i, op in enumerate(ops[6:]):
        w1 |= op << (8 * i)
    return w0, w1


def tables():
    """(jobs, lins, steps, defines): the flat tables of every layout's
    programs and the names the kernels use."""
    jobs, lins, steps, defines = [], [], [], []
    for layout in layouts():
        nv = layout.assign()
        assert nv <= 64                     # a slot in 6 bits
        pre = f"LG_{layout.name}"
        defines.append((f"{pre}_NV", nv))
        for fname, (base, _) in layout.fixed.items():
            defines.append((f"{pre}_{fname}", base))
        for p in layout.programs:
            defines.append((f"{pre}_P_{p.name}", len(steps)))
            defines.append((f"{pre}_P_{p.name}_N", len(p.steps)))
            for name, block in p.exports.items():
                defines.append((f"{pre}_{p.name}_{name}", block.slot))
            for s in p.steps:
                row = [len(jobs), len(s.jobs)]
                jobs.extend(_job_word(*j) for j in s.jobs)
                l0, nl = [], []
                for stage in s.lins:
                    l0.append(len(lins))
                    nl.append(len(stage))
                    # the longest chains first: output j goes to thread j
                    # mod G, so they spread over the group
                    lins.extend(_lin_words(*lin) for lin in sorted(
                        stage, key=lambda lin: -len(lin_ops(lin[1]))))
                assert all(nl[i] or not nl[i + 1] for i in range(2))
                steps.append(row + l0 + nl)
    return jobs, lins, steps, defines


def render() -> str:
    jobs, lins, steps, defines = tables()
    out = ["// Generated by python -m lighthouse_tpu_torch.ops.bls_lane: the",
           "// lane programs of the lane-group kernels (coop.cuh lg_step).",
           "// Do not edit. In global memory, not __constant__: the groups of",
           "// a warp read different entries, which the constant cache",
           "// serializes.", "#pragma once", ""]
    out += [f"#define {n} {v}" for n, v in defines]
    out += ["", f"__device__ const unsigned long long LG_JOB[{len(jobs)}] = {{"]
    out += [",\n".join("    " + ", ".join(f"0x{w:012x}ull" for w in
                                          jobs[i:i + 4])
                       for i in range(0, len(jobs), 4)), "};", ""]
    out += [f"__device__ const unsigned long long LG_LIN[{2 * len(lins)}] = {{"]
    out += [",\n".join(f"    0x{a:016x}ull, 0x{b:016x}ull" for a, b in lins),
            "};", ""]
    out += [f"__device__ const LgStep LG_STEP[{len(steps)}] = {{"]
    out += [",\n".join("    {" + ", ".join(str(v) for v in row) + "}"
                       for row in steps), "};", ""]
    return "\n".join(out)


# ----------------------------------------------------- a Python executor

def decode_job(w: int):
    dst, xa, xb, ya, yb = ((w >> (8 * i)) & 255 for i in range(5))
    f = w >> 40
    return dst, (xa, xb if f & 1 else None, -1 if f & 2 else 1), \
        (ya, yb if f & 4 else None, -1 if f & 8 else 1), bool(f & 16)


def decode_lin(w0: int, w1: int):
    """(the slot written, its operations)."""
    n = (w0 >> 6) & 15
    ops = [(w0 >> (10 + 8 * i)) & 255 if i < 6 else (w1 >> (8 * (i - 6))) & 255
           for i in range(n)]
    return w0 & 63, ops


def run_step(V: list, step: int, p: int, mul=None, table=None) -> None:
    """Step ``step`` of the rendered tables on slots ``V`` (integers mod
    p); ``mul``: the field product (plain a b mod p by default)."""
    jobs, lins, steps, _ = table or tables()
    mul = mul or (lambda a, b: a * b % p)
    j0, nj, *rest = steps[step]
    l0, nl = rest[:LIN_STAGES], rest[LIN_STAGES:]

    def operand(o):
        a, b, sign = o
        return V[a] if b is None else (V[a] + sign * V[b]) % p

    out = []
    for w in jobs[j0:j0 + nj]:
        dst, x, y, dbl = decode_job(w)
        out.append((dst, mul(operand(x), operand(y)) * (2 if dbl else 1) % p))
    for dst, v in out:
        V[dst] = v
    for k in range(LIN_STAGES):
        out = []
        for w0, w1 in lins[l0[k]:l0[k] + nl[k]]:
            dst, ops = decode_lin(w0, w1)
            acc = 0
            for op in ops:
                x = acc if op & OP_DBL else V[op & 63]
                acc = (acc - x if op & OP_SUB else acc + x) % p
            out.append((dst, acc))
        for dst, v in out:
            V[dst] = v


if __name__ == "__main__":
    print(render(), end="")
