#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (teku_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   -- compile every CUDA source of teku_tpu_torch/ops/kernels with
              nvcc (in parallel) and print the build time and the ptxas
              register / stack / spill report.
2. parity  -- hold each kernel against its plain PyTorch version on the
              card, on a seeded 8-lane batch through both scalars paths
              (the ladder and the GLV + Pippenger MSM), and scalars_msm
              at the 256-lane batch's shapes (exact: integer arithmetic).
3. verify  -- drive TorchBls12381(device="cuda") through batch_verify:
              workload A, a 256-lane batch of single-key attestations
              over 4 messages (rows of 32), under the msm path rule's
              `auto` (must resolve to pippenger) and forced onto the
              ladder; workload B, a 64-lane batch of 128-key aggregates
              over 64 messages, under `auto` (must resolve to the
              ladder).  Each must verify, and a copy with one swapped
              signature must not.  Launch counters are zeroed just before
              each of the three paths and read just after it: each path
              must have launched its own scalars kernel and not the
              other's, and every kernel must have launched on some path.
              Then the valid A batch runs warm 7 times on each path,
              interleaved (median and spread of the batch wall time).
4. timing  -- each kernel at workload A's shapes (CUDA events; finish
              on both the 1-lane wsig of scalars_msm and the 256-lane
              wsig of scalars_group), held against its plain version on
              the same inputs and timed there, and its bound: the
              int32 multiply-adds it executes on these inputs (counted by
              the host C++ build of the same source: 576 per Montgomery
              product) over the card's IMAD rate, or its bytes over the
              memory rate, whichever is larger.

Prints the card's name and power limit, one JSON line of per-kernel
numbers (a row per kernel and scalars path it was timed on, with its
launches on that path), and last {"ok": true, "device": {...}}.  Keys
and signatures come from the port's pure-Python oracle with --seed
(default 2026).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

# H100 SXM: 64 32-bit integer multiply-adds per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput table, compute capability 9.0)
IMAD_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
MADS_PER_MONT_MUL = 576             # fp381.cuh: 12 rows x 4 chains x 12

KERNELS = {
    # wrapper: (kernel source stem, the TPU program it replaces)
    "g1_validate": ("decompress", "teku_tpu/ops/provider.py:456"),
    "prepare": ("decompress", "teku_tpu/ops/verify.py:169"),
    "h2c": ("h2c", "teku_tpu/ops/verify.py:182"),
    "scalars_group": ("scalars_group", "teku_tpu/ops/verify.py:200"),
    "scalars_msm": ("msm", "teku_tpu/ops/verify.py:246 + ops/msm.py:333-493"),
    "miller": ("pairing", "teku_tpu/ops/verify.py:266"),
    "finish": ("pairing", "teku_tpu/ops/verify.py:272"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# --------------------------------------------------------------------------
# Inputs from the oracle
# --------------------------------------------------------------------------

class Signer:
    """Seeded keys and signatures, signatures as sk * H(m) (H once per m)."""

    def __init__(self, seed: int, n_keys: int):
        import numpy as np
        from teku_tpu_torch.crypto.bls import curve as C
        from teku_tpu_torch.crypto.bls.constants import R
        self.C, self.R = C, R
        rng = np.random.default_rng(seed)
        self.sks = [int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
                    for _ in range(n_keys)]
        self.pks = [C.g1_compress(C.point_mul(C.FQ_OPS, k, C.G1_GENERATOR))
                    for k in self.sks]
        self._hm = {}

    def sign(self, keys, msg: bytes) -> bytes:
        from teku_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
        C = self.C
        if msg not in self._hm:
            self._hm[msg] = hash_to_g2(msg)
        k = sum(self.sks[i] for i in keys) % self.R
        return C.g2_compress(C.point_mul(C.FQ2_OPS, k, self._hm[msg]))

    def triple(self, keys, msg: bytes):
        return ([self.pks[i] for i in keys], msg, self.sign(keys, msg))


def swap_sig(triples, a: int, b: int):
    out = list(triples)
    out[a] = (triples[a][0], triples[a][1], triples[b][2])
    return out


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_build():
    from teku_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.1f} s "
        f"(nvcc wall {_build.BUILD_INFO.get('seconds', 0.0):.1f} s, "
        f"{_build.BUILD_INFO['dir']})")
    for src, report in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        entry, spills = "?", 0
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = re.sub(r"^_Z\d+", "", m.group(1)).split("_kernel")[0]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills += int(m.group(1))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes cumulative "
                          r"stack size", line)
            if m:
                log(f"[build] {src}.cu {entry}: {m.group(1)} registers, "
                    f"{m.group(2)} bytes stack")
        log(f"[build] {src}.cu: {spills} bytes of spill stores in all")
    t0 = time.perf_counter()
    for src in _build.SOURCES:
        _build.library(src)
    log(f"[build] loaded {len(_build.SOURCES)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")


def max_err(a, b) -> int:
    import torch
    if a.dtype == torch.bool:
        return int((a != b).sum())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def run_stages(plan, dev, runner):
    """Each kernel's inputs and outputs for one dispatch plan, the chain
    fed by `runner(name, *args)` (kernel or plain)."""
    import torch

    def d(a):
        return torch.from_numpy(a).to(dev)

    slots, missing, digests, draws = plan["hm_plan"]
    if draws is None:
        raise ValueError("plan has no h2c misses")
    u = d(draws)
    ins = {"h2c": (u[:, 0:2].contiguous(), u[:, 2:4].contiguous())}
    out = {"h2c": runner("h2c", *ins["h2c"])}
    hm = out["h2c"][:plan["group_idx"].shape[0]].contiguous()
    ins["prepare"] = tuple(d(plan[k]) for k in (
        "pk_x", "pk_y", "pk_present", "sig_x0", "sig_x1", "sig_large",
        "sig_inf", "lane_valid"))
    out["prepare"] = runner("prepare", *ins["prepare"])
    pk_jac, sig_jac, lane_ok, mmask = out["prepare"]
    if plan["msm_path"] == "pippenger":
        scalars, mult = "scalars_msm", d(plan["glv_digits"])
    else:
        scalars, mult = "scalars_group", d(plan["r"])
    ins[scalars] = (pk_jac, sig_jac, mult, mmask, d(plan["group_idx"]),
                    d(plan["group_present"]))
    out[scalars] = runner(scalars, *ins[scalars])
    agg, u_mask, wsig = out[scalars]
    ins["miller"] = (agg, hm, u_mask)
    out["miller"] = runner("miller", *ins["miller"])
    ins["finish"] = (out["miller"], wsig)
    out["finish"] = runner("finish", *ins["finish"])
    return ins, out


def kernel_runner(host=False):
    """run(name, *args): the kernel's launch on the CUDA build (or the host
    C++ build), bypassing the wrapper and its launch counter."""
    from teku_tpu_torch.ops.kernels import decompress as KD
    from teku_tpu_torch.ops.kernels import h2c as KH
    from teku_tpu_torch.ops.kernels import lib
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    table = {"g1_validate": KD._run_g1_validate, "prepare": KD._run_prepare,
             "h2c": KH._run_h2c, "scalars_group": KS._run_scalars_group,
             "scalars_msm": KM._run_scalars_msm,
             "miller": KP._run_miller, "finish": KP._run_finish}

    def run(name, *args):
        return table[name](lib(KERNELS[name][0], host=host), *args)
    return run


def plain_runner():
    from teku_tpu_torch.ops.kernels import decompress as KD
    from teku_tpu_torch.ops.kernels import h2c as KH
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    table = {"g1_validate": KD.g1_validate_plain,
             "prepare": KD.prepare_plain, "h2c": KH.h2c_plain,
             "scalars_group": KS.scalars_group_plain,
             "scalars_msm": KM.scalars_msm_plain,
             "miller": KP.miller_plain, "finish": KP.finish_plain}
    return lambda name, *args: table[name](*args)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def phase_parity(signer, dev):
    import numpy as np
    import torch
    from teku_tpu_torch.ops import limbs as fp
    from teku_tpu_torch.ops.kernels import fp381 as KF
    from teku_tpu_torch.ops import msm
    from teku_tpu_torch.ops.kernels import lib
    from teku_tpu_torch.ops.provider import TorchBls12381, parse_g1_wire
    from teku_tpu_torch.crypto.bls.constants import P
    rng = np.random.default_rng(7)
    ok_all = True

    def report(name, errs):
        nonlocal ok_all
        err = max(errs)
        ok_all &= err == 0
        log(f"[parity] {name:14s} {'pass' if err == 0 else 'FAIL'} "
            f"(max |kernel - plain| = {err}, tolerance 0)")

    # fp381 entry points on random canonical elements
    def rand_words(n, width):
        vals = [int.from_bytes(rng.bytes(48), "big") % P
                for _ in range(n * width)]
        return torch.from_numpy(np.stack([fp.int_to_words(v) for v in vals])
                                ).reshape(n, 12 * width).to(dev)
    for op, (_, width, nargs) in KF.OPS.items():
        a = rand_words(8, width)
        b = rand_words(8, width) if nargs == 2 else None
        k = KF._run(lib("fp381"), op, a, b)
        report(f"fp381:{op}", [max_err(k, KF.fp381_ops_plain(op, a, b))])

    # g1_validate: 8 keys and 8 x values off the curve or the subgroup
    xs, large = [], []
    for pk in signer.pks[:8]:
        x, lg, _ = parse_g1_wire(pk)
        xs.append(x)
        large.append(lg)
    for i in range(8):
        xs.append(int.from_bytes(rng.bytes(48), "big") % P)
        large.append(bool(i & 1))
    xw = torch.from_numpy(np.stack([fp.int_to_words(x) for x in xs])).to(dev)
    lg = torch.tensor(large, device=dev)
    k = kernel_runner()("g1_validate", xw, lg)
    p = plain_runner()("g1_validate", xw, lg)
    report("g1_validate", [max_err(a, b) for a, b in zip(k, p)])

    # the verify chain on an 8-lane batch (2-key lanes, 3 messages, one
    # infinity signature lane, one swapped signature) through each
    # scalars path; on pippenger, finish takes a 1-lane wsig
    msgs = [b"p0", b"p0", b"p1", b"p1", b"p1", b"p2", b"p2", b"p0"]
    triples = [signer.triple([2 * i % 32, (2 * i + 1) % 32], m)
               for i, m in enumerate(msgs)]
    triples[3] = (triples[3][0], triples[3][1], bytes([0xC0] + [0] * 95))
    triples = swap_sig(triples, 5, 6)
    prov = TorchBls12381(device=dev)
    semis = [prov.prepare_batch_verify(t) for t in triples]
    kr = kernel_runner()
    for path in ("ladder", "pippenger"):
        with msm.force(path):
            plan = prov.plan(semis, randomize=True)
        ins, pout = run_stages(plan, dev, plain_runner())
        for name in pout:
            kout = as_tuple(kr(name, *ins[name]))
            report(f"{name}/{path}", [max_err(a, b) for a, b in
                                      zip(kout, as_tuple(pout[name]))])
    # scalars_msm at workload A's shapes: 256 lanes in 8 rows of 32,
    # 512 G2 columns in 16 segments
    semis = [prov.prepare_batch_verify(t) for t in workload_a(signer)]
    plan = prov.plan(semis, randomize=True)
    if plan["msm_path"] != "pippenger":
        fail(f"workload A resolved to {plan['msm_path']} under auto")
    t = {k: torch.from_numpy(v).to(dev) for k, v in plan.items()
         if isinstance(v, np.ndarray)}
    pk_jac, sig_jac, _, mmask = kr("prepare", *(t[k] for k in (
        "pk_x", "pk_y", "pk_present", "sig_x0", "sig_x1", "sig_large",
        "sig_inf", "lane_valid")))
    args = (pk_jac, sig_jac, t["glv_digits"], mmask, t["group_idx"],
            t["group_present"])
    report("scalars_msm/A", [max_err(a, b) for a, b in zip(
        kr("scalars_msm", *args), plain_runner()("scalars_msm", *args))])
    torch.cuda.synchronize()
    if not ok_all:
        fail("a kernel disagrees with its plain version")


def workload_a(signer):
    """256 single-key attestations over 4 messages (rows of 32)."""
    msgs = [b"attestation-%d" % (i % 4) for i in range(256)]
    return [signer.triple([i], m) for i, m in enumerate(msgs)]


def workload_b(signer):
    """64 aggregates of 128 keys over 64 messages (rows of 1)."""
    return [signer.triple([(2 * lane + j) % len(signer.sks)
                           for j in range(128)], b"aggregate-%d" % lane)
            for lane in range(64)]


# the scalars kernel each resolved path launches
SCALARS = {"pippenger": "scalars_msm", "ladder": "scalars_group"}
WARM_REPS = 7


def phase_verify(signer, dev, recorder):
    """Drive the three paths; returns {group: launches} and the warm
    repeats of A per path."""
    import torch
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops import msm
    from teku_tpu_torch.ops.provider import TorchBls12381
    batch_a, batch_b = workload_a(signer), workload_b(signer)
    # (group, configured path, resolved path, [(label, triples, verdict)]);
    # A's first batch and B's first batch are cold
    groups = [
        ("A/auto", "auto", "pippenger", [
            ("A: 256 lanes x 1 key, 4 messages", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 5, 6), False)]),
        ("A/ladder", "ladder", "ladder", [
            ("A", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 7, 8), False)]),
        ("B/auto", "auto", "ladder", [
            ("B: 64 lanes x 128 keys, 64 messages", batch_b, True),
            ("B, one swapped signature", swap_sig(batch_b, 3, 4), False)])]
    prov = TorchBls12381(device=dev)
    launches = {}
    for group, path, resolved, cases in groups:
        results = []
        torch.cuda.synchronize()
        K.reset_launches()
        recorder.group = group
        for label, triples, expect in cases:
            before = dict(prov.msm_dispatches)
            with msm.force(path):
                t0 = time.perf_counter()
                got = prov.batch_verify(triples)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            ran = [p for p, c in prov.msm_dispatches.items() if c != before[p]]
            results.append((label, got, expect, dt, ran))
        recorder.group = None
        launches[group] = {name: K.LAUNCHES[name] for name in KERNELS}
        for label, got, expect, dt, ran in results:
            log(f"[verify] {group} {label}: {got} (expected {expect}) on "
                f"{ran} in {dt * 1e3:.1f} ms")
        log(f"[verify] {group} launches: {json.dumps(launches[group])}")
        for label, got, expect, _, ran in results:
            if got is not expect:
                fail(f"{group} batch '{label}' verified {got}, expected "
                     f"{expect}")
            if ran != [resolved]:
                fail(f"{group} batch '{label}' ran the scalars path {ran}, "
                     f"expected {resolved}")
        other = SCALARS["ladder" if resolved == "pippenger" else "pippenger"]
        for name in ("prepare", SCALARS[resolved], "miller", "finish"):
            if launches[group][name] < 1:
                fail(f"{group}: kernel {name} was not launched")
        if launches[group][other] != 0:
            fail(f"{group}: {other} launched on the {resolved} path")
    for name in KERNELS:
        if not any(c[name] for c in launches.values()):
            fail(f"kernel {name} was not launched on the main path")
    # warm repeats of the valid A batch on each path, interleaved
    warm = {"auto": [], "ladder": []}
    for _ in range(WARM_REPS):
        for path, times in warm.items():
            with msm.force(path):
                t0 = time.perf_counter()
                got = prov.batch_verify(batch_a)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm A under {path} verified {got}")
    diffs = sorted(a - b for a, b in zip(warm["auto"], warm["ladder"]))
    for path, times in warm.items():
        ts = sorted(times)
        log(f"[verify] A warm under {path}, {WARM_REPS} repeats: median "
            f"{ts[len(ts) // 2]:.2f} ms, min {ts[0]:.2f}, max {ts[-1]:.2f}")
    log(f"[verify] A warm, auto - ladder per interleaved pair: median "
        f"{diffs[len(diffs) // 2]:+.2f} ms, min {diffs[0]:+.2f}, "
        f"max {diffs[-1]:+.2f}")
    log(f"[verify] msm dispatches: {json.dumps(prov.msm_dispatches)}")
    return launches


class Recorder:
    """Keeps the first call's arguments of each kernel wrapper per verify
    group (wraps the module attributes the provider calls)."""

    def __init__(self):
        from teku_tpu_torch.ops.kernels import decompress as KD
        from teku_tpu_torch.ops.kernels import h2c as KH
        from teku_tpu_torch.ops.kernels import msm as KM
        from teku_tpu_torch.ops.kernels import pairing as KP
        from teku_tpu_torch.ops.kernels import scalars_group as KS
        self.group = None
        self.args = {}
        for mod, name in ((KD, "g1_validate"), (KD, "prepare"), (KH, "h2c"),
                          (KS, "scalars_group"), (KM, "scalars_msm"),
                          (KP, "miller"), (KP, "finish")):
            self._wrap(mod, name)

    def _wrap(self, mod, name):
        orig = getattr(mod, name)

        def wrapper(*args):
            key = (self.group, name)
            if self.group is not None and key not in self.args:
                self.args[key] = args
            return orig(*args)
        setattr(mod, name, wrapper)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(xs) -> int:
    import torch
    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


# (kernel, verify group whose first call it is timed on): workload A's
# shapes; finish on both wsig widths (1 lane from scalars_msm, 256 from
# scalars_group)
TIMED = [("g1_validate", "A/auto"), ("prepare", "A/auto"), ("h2c", "A/auto"),
         ("scalars_group", "A/ladder"), ("scalars_msm", "A/auto"),
         ("miller", "A/auto"), ("finish", "A/auto"), ("finish", "A/ladder")]
GROUP_PATH = {"A/auto": "pippenger", "A/ladder": "ladder"}


def phase_timing(recorder, launches, dev):
    import torch
    from teku_tpu_torch.ops import _build
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    imad_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    log(f"[timing] {props.multi_processor_count} SMs at max {clock_mhz:.0f} "
        f"MHz: {imad_rate / 1e12:.2f} T IMAD/s; HBM {HBM_BYTES_PER_S / 1e12} TB/s")
    kr, pr, hr = kernel_runner(), plain_runner(), kernel_runner(host=True)
    rows = []
    for name, group in TIMED:
        stem, replaces = KERNELS[name]
        args = recorder.args[(group, name)]
        kout = as_tuple(kr(name, *args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pout = as_tuple(pr(name, *args))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_err(a, b) for a, b in zip(kout, pout))
        ms = cuda_ms(lambda: kr(name, *args), reps=3)
        host_lib = _build.library(stem, host=True)
        before = host_lib.fp381_mul_count()
        hr(name, *[a.cpu() for a in args])
        muls = host_lib.fp381_mul_count() - before
        mads = muls * MADS_PER_MONT_MUL
        ops_ms = mads / imad_rate * 1e3
        bytes_ms = (nbytes(args) + nbytes(kout)) / HBM_BYTES_PER_S * 1e3
        shapes = ", ".join("x".join(str(d) for d in a.shape) for a in args
                           if torch.is_tensor(a))
        log(f"[timing] {name:14s} {group:8s} in ({shapes}): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, {mads:.3e} IMAD -> "
            f"bound {max(ops_ms, bytes_ms):.4f} ms")
        rows.append({"name": name, "path": GROUP_PATH[group], "route": "cuda",
                     "source": f"teku_tpu_torch/ops/kernels/{stem}.cu",
                     "replaces": replaces, "launches": launches[group][name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": None})
        if err != 0:
            fail(f"{name} disagrees with its plain version at {group}'s "
                 f"shapes")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import teku_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the teku_tpu_torch package is not beside chip_smoke.py: {exc}")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    t0 = time.perf_counter()
    signer = Signer(args.seed, 256)
    log(f"[inputs] 256 seeded keys in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity(signer, dev)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    recorder = Recorder()
    launches = phase_verify(signer, dev, recorder)
    rows = phase_timing(recorder, launches, dev)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
