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
              `auto` (must resolve to the ladder, as the reference's rule
              does off a TPU), forced onto pippenger and forced onto the
              ladder; workload B, a 64-lane batch of 128-key aggregates
              over 64 messages, under `auto` (the ladder).  Each must
              verify, and a copy with one swapped signature must not.
              Launch counters are zeroed just before each of the four
              paths and read just after it: each path must have launched
              its own scalars kernel and not the other's, and every
              kernel must have launched on some path.  Then the valid A
              batch runs warm 7 times on each of A's paths, interleaved
              (median and spread of the batch wall time).
4. kzg     -- drive the blob path: the mainnet trusted setup (the port's
              copy of the ceremony file), TorchKzg(device="cuda") behind
              crypto/kzg's set_backend; 9 seeded blobs, their commitments
              and proofs through the facade (kzg_msm over the 4096
              Lagrange points), one commitment held against the host
              Pippenger g1_msm; verify_blob_kzg_proof_batch on 6 blobs
              (MAX_BLOBS_PER_BLOCK) valid, with swapped proofs, with a
              field element set to r and with a malformed commitment;
              verify_kzg_proof valid and with y + 1; 9 blobs
              (MAX_BLOBS_PER_BLOCK_ELECTRA) valid and with one bad
              proof; the zero blob's infinity commitment.  Counters are
              zeroed before and read after: kzg_eval, kzg_fold, kzg_msm
              and g1_validate must have launched.  Then the warm 6- and
              9-blob batches, 7 repeats each, interleaved, and 7 more
              of each with the host clock around every stage of the
              batch (G1 cache, challenges, range check, kzg_eval and
              its packing, multipliers, kzg_fold and its packing).
5. timing  -- each kernel at the main path's shapes (A's for the BLS
              kernels, finish on both the 1-lane wsig of scalars_msm and
              the 256-lane wsig of scalars_group; the KZG path's for the
              KZG kernels), CUDA events, held against its plain version
              on the same inputs and timed there, and its bound: the
              int32 multiply-adds of the work over the card's IMAD rate
              (576 per Fq and 256 per Fr Montgomery product), or its
              bytes over the memory rate, whichever is larger.  The work
              of a BLS kernel is the products the host C++ build of the
              same source executes on these inputs; that of a KZG
              function the least its real inputs need (kzg_least_work),
              with the kernel's own count printed beside it.

Prints the card's name and power limit, one JSON line of per-kernel
numbers (a row per kernel and path it was timed on -- ladder, pippenger,
kzg -- with its launches on that path), and last {"ok": true, "device":
{...}}.  Keys and signatures come from the port's pure-Python oracle,
blobs from numpy, both with --seed (default 2026).
"""

import argparse
import contextlib
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
MADS_PER_FR_MUL = 256               # fr255.cuh: 8 rows x 4 chains x 8

KERNELS = {
    # wrapper: (kernel source stem, the TPU program it replaces)
    "g1_validate": ("decompress", "teku_tpu/ops/provider.py:456"),
    "prepare": ("decompress", "teku_tpu/ops/verify.py:169"),
    "h2c": ("h2c", "teku_tpu/ops/verify.py:182"),
    "scalars_group": ("scalars_group", "teku_tpu/ops/verify.py:200"),
    "scalars_msm": ("msm", "teku_tpu/ops/verify.py:246 + ops/msm.py:333-493"),
    "miller": ("pairing", "teku_tpu/ops/verify.py:266"),
    "finish": ("pairing", "teku_tpu/ops/verify.py:272"),
    "kzg_eval": ("kzg", "teku_tpu/ops/kzg.py:112"),
    "kzg_fold": ("kzg", "teku_tpu/ops/kzg.py:149"),
    "kzg_msm": ("kzg", "teku_tpu/ops/kzg.py:180"),
}
BLS_KERNELS = ("g1_validate", "prepare", "h2c", "scalars_group",
               "scalars_msm", "miller", "finish")
KZG_KERNELS = ("g1_validate", "kzg_eval", "kzg_fold", "kzg_msm")


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
    from teku_tpu_torch.ops.kernels import kzg as KK
    from teku_tpu_torch.ops.kernels import lib
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    table = {"g1_validate": KD._run_g1_validate, "prepare": KD._run_prepare,
             "h2c": KH._run_h2c, "scalars_group": KS._run_scalars_group,
             "scalars_msm": KM._run_scalars_msm,
             "miller": KP._run_miller, "finish": KP._run_finish,
             "kzg_eval": KK._run_kzg_eval, "kzg_fold": KK._run_kzg_fold,
             "kzg_msm": KK._run_kzg_msm}

    def run(name, *args):
        return table[name](lib(KERNELS[name][0], host=host), *args)
    return run


def plain_runner():
    from teku_tpu_torch.ops.kernels import decompress as KD
    from teku_tpu_torch.ops.kernels import h2c as KH
    from teku_tpu_torch.ops.kernels import kzg as KK
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    table = {"g1_validate": KD.g1_validate_plain,
             "prepare": KD.prepare_plain, "h2c": KH.h2c_plain,
             "scalars_group": KS.scalars_group_plain,
             "scalars_msm": KM.scalars_msm_plain,
             "miller": KP.miller_plain, "finish": KP.finish_plain,
             "kzg_eval": KK.kzg_eval_plain, "kzg_fold": KK.kzg_fold_plain,
             "kzg_msm": KK.kzg_msm_plain}
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
    with msm.force("pippenger"):
        plan = prov.plan(semis, randomize=True)
    if plan["msm_path"] != "pippenger":
        fail(f"workload A resolved to {plan['msm_path']} under pippenger")
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


def spread(times, signed=False) -> str:
    ts = sorted(times)
    f = "{:+.2f}" if signed else "{:.2f}"
    return (f"median {f.format(ts[len(ts) // 2])} ms, min "
            f"{f.format(ts[0])}, max {f.format(ts[-1])}")


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
        ("A/auto", "auto", "ladder", [
            ("A: 256 lanes x 1 key, 4 messages", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 5, 6), False)]),
        ("A/pippenger", "pippenger", "pippenger", [
            ("A", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 9, 10), False)]),
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
        launches[group] = {name: K.LAUNCHES[name] for name in BLS_KERNELS}
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
    for name in BLS_KERNELS:
        if not any(c[name] for c in launches.values()):
            fail(f"kernel {name} was not launched on the main path")
    # warm repeats of the valid A batch on each path, interleaved
    warm = {"auto": [], "ladder": [], "pippenger": []}
    for _ in range(WARM_REPS):
        for path, times in warm.items():
            with msm.force(path):
                t0 = time.perf_counter()
                got = prov.batch_verify(batch_a)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm A under {path} verified {got}")
    for path, times in warm.items():
        log(f"[verify] A warm under {path}, {WARM_REPS} repeats: "
            f"{spread(times)}")
    for path in ("auto", "pippenger"):
        diffs = [a - b for a, b in zip(warm[path], warm["ladder"])]
        log(f"[verify] A warm, {path} - ladder per interleaved pair: "
            f"{spread(diffs, signed=True)}")
    log(f"[verify] msm dispatches: {json.dumps(prov.msm_dispatches)}")
    return launches


BLOBS_PER_BLOCK = 6            # MAX_BLOBS_PER_BLOCK (Deneb)
BLOBS_PER_BLOCK_ELECTRA = 9    # MAX_BLOBS_PER_BLOCK_ELECTRA


def seeded_blobs(seed: int, n: int):
    """n blobs of 4096 canonical field elements from a seeded generator."""
    import numpy as np
    from teku_tpu_torch.crypto import kzg as HK
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = rng.integers(0, 256, (HK.FIELD_ELEMENTS_PER_BLOB, 32),
                           dtype=np.uint8)
        raw[:, 0] &= 0x3F                  # < 2^254 < r: canonical
        out.append(raw.tobytes())
    return out


def phase_kzg(dev, seed, recorder):
    """The blob path through the crypto/kzg facade on TorchKzg; returns
    the launches of the path's kernels."""
    import torch
    from teku_tpu_torch.crypto import kzg as HK
    from teku_tpu_torch.crypto.bls import curve as C
    from teku_tpu_torch.crypto.bls.constants import R
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops.kzg import TorchKzg
    t0 = time.perf_counter()
    setup = HK.get_setup()
    log(f"[kzg] mainnet trusted setup ({len(setup.g1_lagrange)} G1 "
        f"Lagrange, {len(setup.g2_monomial)} G2 points) loaded in "
        f"{time.perf_counter() - t0:.1f} s from {HK.REFERENCE_SETUP_PATH}")
    backend = TorchKzg(device=dev)
    HK.set_backend(backend)
    blobs = seeded_blobs(seed, BLOBS_PER_BLOCK_ELECTRA)
    zero_blob = bytes(HK.BYTES_PER_BLOB)
    torch.cuda.synchronize()
    K.reset_launches()
    recorder.group = "kzg"
    t0 = time.perf_counter()
    cms = [HK.blob_to_kzg_commitment(b) for b in blobs]
    prs = [HK.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cms)]
    zc = HK.blob_to_kzg_commitment(zero_blob)
    zp = HK.compute_blob_kzg_proof(zero_blob, zc)
    log(f"[kzg] {len(blobs) + 1} commitments and proofs through the facade "
        f"in {time.perf_counter() - t0:.1f} s")
    six = slice(0, BLOBS_PER_BLOCK)
    bad_fe = bytearray(blobs[2])
    bad_fe[32 * 100:32 * 101] = R.to_bytes(32, "big")
    poly = HK.blob_to_polynomial(blobs[0])
    z = HK.compute_challenge(blobs[0], cms[0])
    y = HK.evaluate_polynomial_in_evaluation_form(poly, z)
    proof_z, y_z = HK.compute_kzg_proof_impl(poly, z)
    bad9 = list(prs)
    bad9[7] = prs[8]
    cases = [
        ("6 blobs", lambda: HK.verify_blob_kzg_proof_batch(
            blobs[six], cms[six], prs[six]), True),
        ("6 blobs, proofs swapped", lambda: HK.verify_blob_kzg_proof_batch(
            blobs[six], cms[six], prs[1:6] + prs[:1]), False),
        ("6 blobs, a field element set to r",
         lambda: HK.verify_blob_kzg_proof_batch(
             blobs[:2] + [bytes(bad_fe)] + blobs[3:6], cms[six], prs[six]),
         False),
        ("6 blobs, a malformed commitment",
         lambda: HK.verify_blob_kzg_proof_batch(
             blobs[six], [b"\x00" * 48] + cms[1:6], prs[six]), False),
        ("verify_kzg_proof", lambda: backend.verify_kzg_proof(
            cms[0], z, y_z, proof_z, setup), True),
        ("verify_kzg_proof, y + 1", lambda: backend.verify_kzg_proof(
            cms[0], z, (y_z + 1) % R, proof_z, setup), False),
        ("9 blobs", lambda: HK.verify_blob_kzg_proof_batch(
            blobs, cms, prs), True),
        ("9 blobs, one bad proof", lambda: HK.verify_blob_kzg_proof_batch(
            blobs, cms, bad9), False),
        ("the zero blob", lambda: HK.verify_blob_kzg_proof_batch(
            [zero_blob], [zc], [zp]), True)]
    results = []
    for label, fn, expect in cases:
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        results.append((label, got, expect, time.perf_counter() - t0))
    recorder.group = None
    launches = {name: K.LAUNCHES[name] for name in KZG_KERNELS}
    for label, got, expect, dt in results:
        log(f"[kzg] {label}: {got} (expected {expect}) in {dt * 1e3:.1f} ms")
    log(f"[kzg] launches: {json.dumps(launches)}")
    for label, got, expect, _ in results:
        if got is not expect:
            fail(f"kzg case '{label}' gave {got}, expected {expect}")
    if y != y_z:
        fail("evaluate_polynomial and compute_kzg_proof_impl disagree on y")
    if zc != bytes([0xC0] + [0] * 47):
        fail("the zero blob's commitment is not the infinity point")
    for name in KZG_KERNELS:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the KZG path")
    # an independent check of the card's MSM: the host Pippenger
    t0 = time.perf_counter()
    host_cm = C.g1_compress(HK.g1_msm(setup.g1_lagrange, poly))
    log(f"[kzg] blob 0's commitment, card kzg_msm vs host Pippenger g1_msm: "
        f"{'equal' if host_cm == cms[0] else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    if host_cm != cms[0]:
        fail("the card's commitment differs from the host Pippenger's")
    # warm batches, interleaved
    warm = {BLOBS_PER_BLOCK: [], BLOBS_PER_BLOCK_ELECTRA: []}
    for _ in range(WARM_REPS):
        for n, times in warm.items():
            t0 = time.perf_counter()
            got = HK.verify_blob_kzg_proof_batch(blobs[:n], cms[:n], prs[:n])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm {n}-blob batch verified {got}")
    for n, times in warm.items():
        log(f"[kzg] warm {n}-blob batch, {WARM_REPS} repeats: "
            f"{spread(times)}")
    for n in warm:
        stages = StageTimer(backend)
        try:
            for _ in range(WARM_REPS):
                with stages.batch():
                    HK.verify_blob_kzg_proof_batch(blobs[:n], cms[:n],
                                                   prs[:n])
        finally:
            stages.undo()
        log(f"[kzg] stages of the warm {n}-blob batch, host clock, median "
            f"of {WARM_REPS} (ms): {json.dumps(stages.medians())}")
    HK.set_backend(None)
    return launches


class StageTimer:
    """Host-clock time of each stage of TorchKzg.verify_blob_kzg_proof_batch,
    taken by wrapping the functions it calls.  The kernel wrappers
    synchronize the card before and after, so each kernel's time is its
    own and the rest of a stage is host work (packing, copies, readback)."""

    TIMED = ("_resolve_g1", "compute_challenge", "blob_bytes_to_limbs",
             "limbs_lt_modulus", "_evaluate", "kzg_eval", "_r_multipliers",
             "_fold_check", "kzg_fold")

    def __init__(self, backend):
        import teku_tpu_torch.ops.kzg as OK
        from teku_tpu_torch.ops.kernels import kzg as KK
        self.t, self.rows, self._undo = {}, [], []
        owner = {"compute_challenge": OK, "blob_bytes_to_limbs": OK,
                 "limbs_lt_modulus": OK, "kzg_eval": KK, "kzg_fold": KK}
        for attr in self.TIMED:
            self._wrap(owner.get(attr, backend), attr,
                       sync=attr.startswith("kzg_"))

    def _wrap(self, obj, attr, sync):
        import torch
        orig = getattr(obj, attr)
        self._undo.append((obj, attr, orig, attr in vars(obj)))

        def wrapper(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.t[attr] = self.t.get(attr, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, attr, wrapper)

    def undo(self):
        for obj, attr, orig, own in reversed(self._undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)

    @contextlib.contextmanager
    def batch(self):
        import torch
        self.t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        t = {k: v * 1e3 for k, v in self.t.items()}
        total = (time.perf_counter() - t0) * 1e3
        g = lambda k: t.get(k, 0.0)                      # noqa: E731
        check = g("blob_bytes_to_limbs") + g("limbs_lt_modulus")
        top = (g("_resolve_g1") + g("compute_challenge") + g("_evaluate")
               + g("_r_multipliers") + g("_fold_check"))
        self.rows.append({
            "batch": total, "g1 cache": g("_resolve_g1"),
            "challenges (SHA-256)": g("compute_challenge"),
            "range check": check, "kzg_eval": g("kzg_eval"),
            "eval packing and copies": g("_evaluate") - check - g("kzg_eval"),
            "multipliers (SHA-256)": g("_r_multipliers"),
            "kzg_fold": g("kzg_fold"),
            "fold packing and copies": g("_fold_check") - g("kzg_fold"),
            "rest": total - top})

    def medians(self):
        return {k: round(sorted(r[k] for r in self.rows)[len(self.rows) // 2],
                         3) for k in self.rows[0]}


class Recorder:
    """Keeps the first call's arguments of each kernel wrapper per verify
    group (wraps the module attributes TorchBls12381 and TorchKzg call)."""

    def __init__(self):
        from teku_tpu_torch.ops.kernels import decompress as KD
        from teku_tpu_torch.ops.kernels import h2c as KH
        from teku_tpu_torch.ops.kernels import kzg as KK
        from teku_tpu_torch.ops.kernels import msm as KM
        from teku_tpu_torch.ops.kernels import pairing as KP
        from teku_tpu_torch.ops.kernels import scalars_group as KS
        self.group = None
        self.args = {}
        for mod, name in ((KD, "g1_validate"), (KD, "prepare"), (KH, "h2c"),
                          (KS, "scalars_group"), (KM, "scalars_msm"),
                          (KP, "miller"), (KP, "finish"), (KK, "kzg_eval"),
                          (KK, "kzg_fold"), (KK, "kzg_msm")):
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


# (kernel, group whose first call it is timed on): workload A's shapes
# (finish on both wsig widths: 1 lane from scalars_msm, 256 from
# scalars_group) and the KZG path's (eval on the padded 6-blob batch, the
# fold's 32 lanes, the msm's 4096, validation of its 16-lane miss bucket)
TIMED = [("g1_validate", "A/auto"), ("prepare", "A/auto"), ("h2c", "A/auto"),
         ("scalars_group", "A/auto"), ("scalars_msm", "A/pippenger"),
         ("miller", "A/auto"), ("finish", "A/auto"),
         ("finish", "A/pippenger"), ("g1_validate", "kzg"),
         ("kzg_eval", "kzg"), ("kzg_fold", "kzg"), ("kzg_msm", "kzg")]
GROUP_PATH = {"A/auto": "ladder", "A/pippenger": "pippenger", "kzg": "kzg"}
# the TPU program each kernel replaces on the KZG path, where it differs
KZG_REPLACES = {"g1_validate": "teku_tpu/ops/kzg.py:142"}


# G1 point operations in Fq products (fp381.cuh counts squares as
# products): dbl-2009-l, add-2007-bl, and madd-2007-bl for an affine input
G1_DBL, G1_ADD, G1_MADD = 7, 16, 11
SCALAR_BITS = 255


def pow_chain(modulus: int) -> int:
    """Products of a square-and-multiply inverse x^(m - 2)."""
    e = modulus - 2
    return e.bit_length() - 1 + bin(e).count("1") - 1


def bucket_msm_products(scalars) -> int:
    """Fq products of the cheapest bucket (Pippenger) MSM over these
    scalars' points (affine inputs), the window width c chosen for them:
    per window one mixed add per nonzero digit and 2 (2^c - 1) adds for
    the bucket sums; c doublings and one add per window to combine."""
    import numpy as np
    words = scalars.cpu().numpy().astype(np.uint32).view(np.uint8)
    bits = np.unpackbits(words.reshape(-1, 32), axis=1,
                         bitorder="little")[:, :SCALAR_BITS]
    best = None
    for c in range(1, 17):
        nwin = -(-SCALAR_BITS // c)
        padded = np.zeros((bits.shape[0], nwin * c), dtype=np.uint8)
        padded[:, :SCALAR_BITS] = bits
        nonzero = int(padded.reshape(-1, nwin, c).any(axis=2).sum())
        cost = (nonzero * G1_MADD + nwin * 2 * ((1 << c) - 1) * G1_ADD
                + (nwin - 1) * (c * G1_DBL + G1_ADD))
        best = cost if best is None else min(best, cost)
    return best


def kzg_least_work(name, args, pairing_products):
    """(Fq products, Fr products, bytes) that a KZG function needs on this
    run's real inputs -- padding blobs and lanes, absent points and zero
    scalars need nothing: eval, per blob that misses every root, one
    product for p_i w_i, three for one batched inversion and one for the
    term per point, plus one inverse and z^n; fold and msm, the cheapest
    bucket MSM of the used points (fold: each group's), one inverse to
    affine per sum, and for fold two Miller loops and one final
    exponentiation (`pairing_products`).  The bytes are each real input
    read once and each output written once."""
    import torch
    from teku_tpu_torch.crypto.bls.constants import P, R
    to_affine = pow_chain(P) + 4
    if name == "kzg_eval":
        poly, z, roots = args
        n = roots.shape[0]
        real = [b for b in range(z.shape[0]) if bool(z[b].any())]
        misses = sum(1 for b in real
                     if not bool((roots == z[b]).all(dim=1).any()))
        fr = misses * (5 * n + pow_chain(R) + n.bit_length() + 1)
        return 0, fr, len(real) * (n * 32 + 64) + n * 32
    if name == "kzg_fold":
        xs, ys, inf, valid, group_b, scalars, g2 = args
        used = valid & ~inf & scalars.ne(0).any(dim=1)
        fq = pairing_products + 2 * to_affine
        for grp in (used & ~group_b, used & group_b):
            fq += bucket_msm_products(scalars[grp])
        return fq, 0, int(used.sum()) * (96 + 32 + 3) + 384 + 1 + 194
    xs, ys, present, scalars = args                       # kzg_msm
    used = present & scalars.ne(0).any(dim=1)
    return (bucket_msm_products(scalars[used]) + to_affine, 0,
            int(used.sum()) * (96 + 32 + 1) + 97)


def host_products(stem, name, args):
    """(Fq, Fr) products the host C++ build of the kernel executes."""
    from teku_tpu_torch.ops import _build
    host_lib = _build.library(stem, host=True)
    fr_count = getattr(host_lib, "fr_mul_count", lambda: 0)
    before = (host_lib.fp381_mul_count(), fr_count())
    kernel_runner(host=True)(name, *[a.cpu() for a in args])
    return (host_lib.fp381_mul_count() - before[0],
            fr_count() - before[1])


def phase_timing(recorder, launches, dev):
    import torch
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    imad_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    log(f"[timing] {props.multi_processor_count} SMs at max {clock_mhz:.0f} "
        f"MHz: {imad_rate / 1e12:.2f} T IMAD/s; HBM {HBM_BYTES_PER_S / 1e12} TB/s")
    kr, pr = kernel_runner(), plain_runner()
    # two Miller loops and one final exponentiation, as pairing.cuh
    # computes them: pairing.cu's miller on one lane plus its finish on one
    # row and one lane (one more Miller loop and the final exponentiation)
    agg, hm, _ = recorder.args[("A/pippenger", "miller")]
    ml, wsig = recorder.args[("A/pippenger", "finish")]
    pairing_products = (
        host_products("pairing", "miller", (agg[:1], hm[:1],
                                            torch.ones(1, dtype=torch.bool)))[0]
        + host_products("pairing", "finish", (ml[:1], wsig[:1]))[0])
    log(f"[timing] 2 Miller loops + 1 final exponentiation: "
        f"{pairing_products} Fq products (host build of pairing.cu)")
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
        fq, fr = host_products(stem, name, args)
        executed_ms = ((fq * MADS_PER_MONT_MUL + fr * MADS_PER_FR_MUL)
                       / imad_rate * 1e3)
        moved = nbytes(args) + nbytes(kout)
        if name.startswith("kzg_"):
            fq, fr, moved = kzg_least_work(name, args, pairing_products)
        elif group == "kzg":
            # g1_validate: the same work on every lane; the bucket's
            # padding lanes (x = 0) are not the path's points
            real = int(args[0].ne(0).any(dim=1).sum())
            fq, fr = fq * real // args[0].shape[0], 0
            moved = moved * real // args[0].shape[0]
        ops_ms = ((fq * MADS_PER_MONT_MUL + fr * MADS_PER_FR_MUL)
                  / imad_rate * 1e3)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        shapes = ", ".join("x".join(str(d) for d in a.shape) for a in args
                           if torch.is_tensor(a))
        log(f"[timing] {name:14s} {group:11s} in ({shapes}): max |kernel "
            f"- plain| = {err} (tolerance 0); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms; bound {max(ops_ms, bytes_ms):.4f} ms "
            f"({fq} Fq + {fr} Fr products, {moved} bytes); the kernel's "
            f"own products {executed_ms:.4f} ms")
        rows.append({"name": name, "path": GROUP_PATH[group], "route": "cuda",
                     "source": f"teku_tpu_torch/ops/kernels/{stem}.cu",
                     "replaces": (KZG_REPLACES.get(name, replaces)
                                  if group == "kzg" else replaces),
                     "launches": launches[group][name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": None, "executed_ops_ms": executed_ms})
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
    t0 = time.perf_counter()
    launches["kzg"] = phase_kzg(dev, args.seed, recorder)
    log(f"[kzg] done in {time.perf_counter() - t0:.1f} s")
    rows = phase_timing(recorder, launches, dev)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
