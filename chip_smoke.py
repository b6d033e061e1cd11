#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (teku_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   -- compile every CUDA source of teku_tpu_torch/ops/kernels with
              nvcc in both Montgomery engines, cios and mma (one parallel
              batch of 16 processes), and print the build time, the ptxas
              register / stack / shared memory / spill report (a stack
              over fp381_init's 32 KB fails) and each library's IMMA
              instruction count from cuobjdump -sass: the mma fp381 and
              pairing libraries must hold some (the tensor cores are
              reached), the cios libraries none.
2. parity  -- hold each kernel against its plain PyTorch version on the
              card, on a seeded 8-lane batch through both scalars paths
              (the ladder and the GLV + Pippenger MSM), and scalars_msm
              at the 256-lane batch's shapes (exact: integer arithmetic);
              then the mesh kernels at workload A's shapes on 4 shards:
              gather_hm (with out-of-range indices), scalars and
              lane_affine (256 lanes with infinity lanes), shard_partials
              (a shard's 2 rows and 64 lanes, and an all-padding shard),
              aggregate_points on G1 and G2 (256 points, some absent).
2a. coop  -- pairing.cuh's cooperative routines (finish's, miller's and
              kzg_fold's: one block of two warps a value) through
              pairing_ops: the Fq12 product, square, cyclotomic square and
              final exponentiation on 8 seeded Fq12 values (cyclotomic
              ones for the cyclotomic square), and the Miller loop through
              miller on 8 seeded affine pairs (3 rows masked), each engine
              against the plain versions on the card, word for word.
2b. row11 -- the Montgomery product alone (TPU program row 11): fp381_ops
              fp_mont and fr_mont (one product a pair, on words taken as
              Montgomery form) and fp_mul and fr_mul (canonical words in
              and out) on the mma build, 4096 seeded pairs plus 0, 1,
              M - 1 and R mod M, word for word against the cios build
              and canonically against the plain digit product
              (mont_mul_mxu, run once on the card).
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
              kernel must have launched on some path.  A and B again on
              a provider built with mont_path="mxu-force" (the mma
              engine): the same verdicts, every launch an mma launch and
              no cios launch (a product that only part of a warp reached
              traps, and the run fails).  Then the valid A batch runs
              warm 7 times on each of A's paths and on the mma engine,
              interleaved (median and spread of the batch wall time).
4. mesh    -- TorchBls12381(mesh=make_mesh(devices=[cuda:0] * 4)), a
              virtual 4-shard mesh on the one card: A under `auto` (the
              ladder) and forced onto pippenger, B under `auto`, each
              valid and with one swapped signature; verdicts, lane_ok and
              h2c_dispatch_count must equal a single-device provider's on
              the same batches.  Then the legacy ShardedVerifier on A (64
              lanes a shard, a Miller row per lane), valid and tampered.
              Counters are zeroed before each path and read after: each
              batch must launch gather_hm once (grouped paths),
              shard_partials once a shard and finish once; the legacy
              path scalars and lane_affine, not scalars_group.  Mesh A
              again on the mma engine, valid and tampered, with the same
              launch counts on that engine.  Then warm A on the mesh
              against warm A on one device, 7 interleaved repeats.
              Then gather_hm against torch.index_select on mesh A's
              inputs (gather_regimes): inside warm mesh A batches, as the
              mesh dispatch calls it with the batch's handle alive (host
              clock around each call, torch.profiler's device time of
              each kernel), and alone: one call (CUDA events, median of
              3), and a call in 100 back-to-back calls with the outputs
              held and with them dropped.
5. kzg     -- drive the blob path: the mainnet trusted setup (the port's
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
              its packing, multipliers, kzg_fold and its packing).  K6
              valid and with swapped proofs on a TorchKzg built with
              mont_path="mxu-force", then warm K6 on both engines, 7
              interleaved repeats.
5b. engines -- every kernel on the mma build against the cios build, word
              for word, on the first inputs each of A (both scalars
              paths), B, mesh A and B, the legacy mesh, K6 and K9 gave
              it; miller (a block per row) and kzg_fold (its pairings and
              final exponentiation on blocks) also against their plain
              versions there: A (8 rows), B (64), mesh A (2 a shard),
              mesh B (16), the legacy mesh (64, a row per lane), K6 and
              K9 (32 lanes).  h2c and prepare (a warp a row or lane,
              wcoop.cuh) on both builds against their plain versions on
              every group that ran them: A on its three scalars paths,
              B, the mesh groups and the mxu-force groups (each distinct
              input's plain version run once); fails if either ran on
              no path.
6. timing  -- each kernel at the main path's shapes (A's for the BLS
              kernels, prepare, h2c and miller also at B's, finish on
              both the 1-lane wsig of scalars_msm and the 256-lane wsig
              of scalars_group; the mesh path's for
              gather_hm and shard_partials, the legacy path's for scalars
              and lane_affine, the parity phase's for aggregate_points,
              which nothing on the path calls; the KZG path's for the
              KZG kernels), CUDA events, held against its plain version
              on the same inputs and timed there, and its bound: the
              int32 multiply-adds of the work over the card's IMAD rate
              (576 per Fq and 256 per Fr Montgomery product), or its
              bytes over the memory rate, whichever is larger.  The work
              of a BLS kernel is the products the host C++ build of the
              same source executes on these inputs, less, in miller and
              finish, what its Miller loops, Fq12 product and final
              exponentiation execute beyond their least work: the fewer
              of the host build's and the plain version's products for
              each (pairing_least_work); in h2c and prepare the fewer of
              the host build's and the plain version's; that of a KZG
              function and of lane_affine the least its real inputs need
              (kzg_least_work, lane_affine_least_work: one batched
              inversion where the kernel inverts per lane), with the
              kernel's own count printed beside it (kzg_fold's pairings:
              pairing_least_work).  gather_hm's time
              and that of torch.index_select, its library call, are a
              call in 100 back-to-back calls with the outputs held, as
              the mesh dispatch holds them (gather_regimes); torch.profiler
              splits a call into its host and device time and counts its
              CUDA launches, kernels, memsets and copies alike (must be 1:
              no fill; no device activity fails).  kzg_fold's CUDA
              kernels a call, device time from torch.profiler, split into
              fold_lane, the halving sums, the two pair blocks and the
              verdict block.  Each kernel is timed on the mma build too,
              on the same inputs.  The final exponentiation alone
              (pairing_ops, one value, as finish and kzg_fold run it) and
              the Miller loop alone (miller, one row), on both engines;
              each cooperative operation's latency (65
              in one launch less one); one Fq inversion on one thread,
              Fermat's and the binary Euclid's (fp381_ops fp_inv and
              fp_inv_euclid, n = 1; finish runs two of the latter).
              Row 11 alone: fp_mont at n = 256 and 2^20 and fr_mont at
              2^20 on both builds (one product a pair), the plain digit
              product beside them, bound by one CIOS product's work a
              pair (576 / 256 IMADs, or its bytes) with the mma
              kernel's own count (int8 MACs of one product) beside it.

Prints the card's name and power limit, one JSON line of per-kernel
numbers (a row per kernel and path it was timed on -- ladder, pippenger,
kzg -- with its launches on that path, and its mma-engine time and
launches on the path's mxu-force twin; rows for row 11 alone), and last
{"ok": true, "device":
{...}}.  Keys and signatures come from the port's pure-Python oracle,
blobs from numpy, both with --seed (default 2026).

    python3 chip_smoke.py --gather-regimes-of DIR

runs gather_regimes alone with the teku_tpu_torch package of another
checkout DIR (such as the parent commit's, unpacked by git archive), to
compare two trees' gather_hm in one call, and prints its numbers as one
JSON line.
"""

import argparse
import contextlib
import json
import os
import re
import shutil
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
    "gather_hm": ("shard", "teku_tpu/ops/verify.py:191"),
    "scalars": ("scalars_group", "teku_tpu/ops/verify.py:200 (in _lane_work "
                ":88)"),
    "lane_affine": ("shard", "teku_tpu/ops/verify.py:209"),
    "shard_partials": ("shard", "teku_tpu/ops/verify.py:399, :476"),
    "aggregate_points": ("shard", "teku_tpu/ops/verify.py:528"),
    "pairing_ops": ("pairing", "teku_tpu/ops/verify.py:112 (_finish's "
                    "final exponentiation, teku_tpu/ops/pairing.py:239)"),
}
BLS_KERNELS = ("g1_validate", "prepare", "h2c", "scalars_group",
               "scalars_msm", "miller", "finish")
MESH_KERNELS = ("gather_hm", "scalars", "lane_affine", "shard_partials",
                "aggregate_points")
SHARDS = 4
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

STACK_LIMIT = 32768                 # fp381_init's per-thread stack


def imma_counts(paths):
    """{(source, engine): IMMA instructions in the library's SASS}, from
    cuobjdump -sass (one process per library, in parallel)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    procs = {k: subprocess.Popen([tool, "-sass", p], stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True)
             for k, p in paths.items()}
    counts = {}
    for k, proc in procs.items():
        sass = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            fail(f"cuobjdump -sass failed on {paths[k]}")
        counts[k] = len(re.findall(r"\bIMMA\b", sass))
    return counts


def phase_build():
    from teku_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} libraries ({len(_build.SOURCES)} sources x "
        f"engines {'/'.join(_build.ENGINES)}) in "
        f"{time.perf_counter() - t0:.1f} s (nvcc wall "
        f"{_build.BUILD_INFO.get('seconds', 0.0):.1f} s, "
        f"{_build.BUILD_INFO.get('processes', 0)} nvcc processes in "
        f"parallel, {_build.BUILD_INFO['dir']})")
    worst = 0
    for (src, engine), report in sorted(
            _build.BUILD_INFO.get("ptxas", {}).items()):
        entry, spills = "?", 0
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = re.split(r"_kernel|_block",
                                 re.sub(r"^_Z\d+", "", m.group(1)))[0]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills += int(m.group(1))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes cumulative "
                          r"stack size(?:, (\d+) bytes smem)?", line)
            if m:
                worst = max(worst, int(m.group(2)))
                smem = f", {m.group(3)} bytes smem" if m.group(3) else ""
                log(f"[build] {src}.cu ({engine}) {entry}: {m.group(1)} "
                    f"registers, {m.group(2)} bytes stack{smem}")
        log(f"[build] {src}.cu ({engine}): {spills} bytes of spill stores "
            f"in all")
    if worst > STACK_LIMIT:
        fail(f"a kernel needs {worst} bytes of stack, over the "
             f"{STACK_LIMIT}-byte limit fp381_init sets")
    log(f"[build] largest cumulative stack {worst} bytes (limit "
        f"{STACK_LIMIT})")
    t0 = time.perf_counter()
    imma = imma_counts(paths)
    log(f"[build] IMMA instructions per library (cuobjdump -sass, "
        f"{time.perf_counter() - t0:.1f} s): " + json.dumps(
            {f"{s}-{e}": n for (s, e), n in sorted(imma.items())}))
    for src in ("fp381", "pairing"):
        if imma[(src, "mma")] == 0:
            fail(f"the mma build of {src}.cu has no IMMA instruction: the "
                 f"tensor cores are not reached")
    cios_imma = {s: n for (s, e), n in imma.items() if e == "cios" and n}
    if cios_imma:
        fail(f"cios libraries hold IMMA instructions: {cios_imma}")
    t0 = time.perf_counter()
    for src, engine in paths:
        _build.library(src, engine=engine)
    log(f"[build] loaded {len(paths)} libraries in "
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


def kernel_runner(host=False, engine="cios"):
    """run(name, *args): the kernel's launch on the CUDA build of `engine`
    (or the host C++ build), bypassing the wrapper and its launch
    counter."""
    from teku_tpu_torch.ops.kernels import decompress as KD
    from teku_tpu_torch.ops.kernels import h2c as KH
    from teku_tpu_torch.ops.kernels import kzg as KK
    from teku_tpu_torch.ops.kernels import lib
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    from teku_tpu_torch.ops.kernels import shard as KSH
    table = {"g1_validate": KD._run_g1_validate, "prepare": KD._run_prepare,
             "h2c": KH._run_h2c, "scalars_group": KS._run_scalars_group,
             "scalars_msm": KM._run_scalars_msm,
             "miller": KP._run_miller, "finish": KP._run_finish,
             "kzg_eval": KK._run_kzg_eval, "kzg_fold": KK._run_kzg_fold,
             "kzg_msm": KK._run_kzg_msm, "gather_hm": KSH._run_gather_hm,
             "scalars": KS._run_scalars, "lane_affine": KSH._run_lane_affine,
             "shard_partials": KSH._run_shard_partials,
             "aggregate_points": KSH._run_aggregate_points,
             "pairing_ops": KP._run_pairing_ops}

    def run(name, *args):
        return table[name](lib(KERNELS[name][0], host=host, engine=engine),
                           *args)
    return run


def plain_runner():
    from teku_tpu_torch.ops.kernels import decompress as KD
    from teku_tpu_torch.ops.kernels import h2c as KH
    from teku_tpu_torch.ops.kernels import kzg as KK
    from teku_tpu_torch.ops.kernels import msm as KM
    from teku_tpu_torch.ops.kernels import pairing as KP
    from teku_tpu_torch.ops.kernels import scalars_group as KS
    from teku_tpu_torch.ops.kernels import shard as KSH
    table = {"g1_validate": KD.g1_validate_plain,
             "prepare": KD.prepare_plain, "h2c": KH.h2c_plain,
             "scalars_group": KS.scalars_group_plain,
             "scalars_msm": KM.scalars_msm_plain,
             "miller": KP.miller_plain, "finish": KP.finish_plain,
             "kzg_eval": KK.kzg_eval_plain, "kzg_fold": KK.kzg_fold_plain,
             "kzg_msm": KK.kzg_msm_plain, "gather_hm": KSH.gather_hm_plain,
             "scalars": KS.scalars_plain,
             "lane_affine": KSH.lane_affine_plain,
             "shard_partials": KSH.shard_partials_plain,
             "aggregate_points": KSH.aggregate_points_plain,
             "pairing_ops": KP.pairing_ops_plain}
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
    aggregate_args = mesh_parity(semis, plan, pk_jac, sig_jac, dev, report)
    torch.cuda.synchronize()
    if not ok_all:
        fail("a kernel disagrees with its plain version")
    return aggregate_args


# row 11: the Montgomery product itself, each engine's build of fp381.cu
ROW11 = "teku_tpu/ops/mxu.py:195-273"
ROW11_SOURCE = "teku_tpu_torch/ops/kernels/mma_digits.cuh"
# the mma product's own work: two m16n8k32 tiles per operand pair
MACS_PER_MMA_PRODUCT = 2 * 16 * 8 * 32
INT8_OPS_PER_S = 1.979e15          # H100 SXM, dense int8 (2 ops a MAC)
# fp381_ops entry points of the product: fp_mont / fr_mont are one
# Montgomery product a pair (words taken as Montgomery form), fp_mul /
# fr_mul the canonical product (to Montgomery form and back)
ROW11_FIELDS = {"fp_mont": (12, "P"), "fr_mont": (8, "R"),
                "fp_mul": (12, "P"), "fr_mul": (8, "R")}
# (op, n) timed alone: the serving width and a width that fills the card
ROW11_SIZES = (("fp_mont", 256), ("fp_mont", 1 << 20), ("fr_mont", 1 << 20))
PLAIN_CHUNK = 1 << 16              # pairs per call of the plain version


def row11_words(rng, op, n, edges=()):
    """n seeded canonical elements of op's field (top word cut to 28
    bits: below both moduli) and the given edge values, as words."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import limbs as fp
    nw = ROW11_FIELDS[op][0]
    w = rng.integers(0, 1 << 32, (n, nw), dtype=np.uint64).astype(np.uint32)
    w[:, -1] &= 0x0FFFFFFF
    if edges:
        w = np.concatenate([w, fp.ints_to_words(edges, nw).view(np.uint32)])
    return torch.from_numpy(w.view(np.int32).copy())


def row11_modulus(op):
    from teku_tpu_torch.crypto.bls.constants import P, R
    return {"P": P, "R": R}[ROW11_FIELDS[op][1]]


def phase_row11(dev):
    """fp381_ops' products on the mma build (row 11) against the cios
    build, word for word, and against the plain digit product
    (mont_mul_mxu, the plain version) canonically: 4096 seeded pairs
    plus 0, 1, M - 1 and R mod M."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops.kernels import fp381 as KF
    rng = np.random.default_rng(11)
    for op in ROW11_FIELDS:
        m, nw = row11_modulus(op), ROW11_FIELDS[op][0]
        edges = [0, 1, m - 1, (1 << (32 * nw)) % m]
        a = row11_words(rng, op, 4096, edges).to(dev)
        b = row11_words(rng, op, 4096, edges[::-1]).to(dev)
        cios = KF._run(K.lib("fp381"), op, a, b)
        mma = KF._run(K.lib("fp381", engine="mma"), op, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with K.plain_engine("mma"):
            plain = KF.fp381_ops_plain(op, a, b)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        errs = max_err(mma, cios), max_err(mma, plain)
        log(f"[row11] {op} on 4100 pairs: max |mma - cios| = {errs[0]}, "
            f"max |mma - plain mont_mul_mxu| = {errs[1]} (tolerance 0; "
            f"plain digit product on the card {dt:.1f} ms)")
        if any(errs):
            fail(f"row 11: {op} on the mma build disagrees")


COOP_OPS = ("mul", "sqr", "cyclo_sqr", "final_exp")


def fq12_seeded(rng, n, dev):
    """n seeded canonical Fq12 values, (n, 12, 12) words."""
    import numpy as np
    import torch
    from teku_tpu_torch.crypto.bls.constants import P
    from teku_tpu_torch.ops import limbs as fp
    vals = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(12 * n)]
    return torch.from_numpy(np.stack([fp.int_to_words(v) for v in vals])
                            ).reshape(n, 12, 12).to(dev)


def cyclotomic_words(a):
    """The easy part of the final exponentiation of a (plain, where a
    lies): values of the cyclotomic subgroup."""
    from teku_tpu_torch.ops import towers as T
    f = T.fq12_from_words(a)
    g = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    return T.fq12_to_words(T.fq12_mul(T.fq12_frobenius(g, 2), g))


def affine_pairs(rng, n, dev):
    """n seeded pairs (P, Q): [a]G1 and [b]G2 affine, (n, 2, 12) and
    (n, 2, 2, 12) words."""
    import numpy as np
    import torch
    from teku_tpu_torch.crypto.bls import curve as C
    from teku_tpu_torch.crypto.bls.constants import R
    from teku_tpu_torch.ops import limbs as fp

    def k():
        return int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1

    ps = [C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, k(), C.G1_GENERATOR))
          for _ in range(n)]
    qs = [C.to_affine(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, k(),
                                             C.G2_GENERATOR))
          for _ in range(n)]
    agg = np.array([[fp.int_to_words(c) for c in p] for p in ps],
                   dtype=np.int32)
    hm = np.array([[[fp.int_to_words(c) for c in v] for v in q]
                   for q in qs], dtype=np.int32)
    return torch.from_numpy(agg).to(dev), torch.from_numpy(hm).to(dev)


def phase_coop(dev):
    """pairing_ops and miller on each engine against the plain versions on
    the card (exact): 8 seeded values an op, 8 seeded pairs (rows 1, 4
    and 6 masked) for the Miller loop."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops.kernels import pairing as KP
    rng = np.random.default_rng(12)
    a, b = fq12_seeded(rng, 8, dev), fq12_seeded(rng, 8, dev)
    c = cyclotomic_words(fq12_seeded(rng, 8, dev))
    p, q = affine_pairs(rng, 8, dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    mask[[1, 4, 6]] = False
    plain_miller = KP.miller_plain(p, q, mask)
    for engine in K.ENGINES:
        lib = K.lib("pairing", engine=engine)
        err = max_err(KP._run_miller(lib, p, q, mask), plain_miller)
        torch.cuda.synchronize()
        log(f"[coop] {'miller':20s} ({engine}) on 8 pairs, 3 masked: max "
            f"|kernel - plain| = {err} (tolerance 0)")
        if err:
            fail(f"miller on the {engine} build disagrees with its plain "
                 f"version")
        with K.plain_engine(engine):
            for op in COOP_OPS:
                args = (a, b) if op == "mul" else (c,) if op == "cyclo_sqr" \
                    else (a,)
                err = max_err(KP._run_pairing_ops(lib, op, *args),
                              KP.pairing_ops_plain(op, *args))
                torch.cuda.synchronize()
                log(f"[coop] {op:20s} ({engine}) on 8 values: max |kernel - "
                    f"plain| = {err} (tolerance 0)")
                if err:
                    fail(f"pairing_ops {op} on the {engine} build disagrees "
                         f"with its plain version")


def final_exp_rows(imad_rate, launches, finish_ms, counts, dev):
    """The final exponentiation alone at finish's shape (one value):
    pairing_ops on both engines (CUDA events, median of 3) against the
    plain version; bound: its least work, the fewer of `counts`' Fq
    products (the host build's, the plain version's: pairing_least_work).  One
    Fq inversion on one thread (fp381_ops, n = 1), Fermat's and the
    binary Euclid's: finish runs two of the latter (the affine sum, the
    Fq12 inverse).  The Miller loop alone (miller, one row).  And each
    cooperative operation's latency."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops.kernels import fp381 as KF
    from teku_tpu_torch.ops.kernels import pairing as KP
    a = fq12_seeded(np.random.default_rng(13), 1, dev)
    ms, outs = {}, {}
    for engine in K.ENGINES:
        lib = K.lib("pairing", engine=engine)
        run = (lambda lib=lib: KP._run_pairing_ops(lib, "final_exp", a))
        outs[engine] = run()
        ms[("final_exp", engine)] = cuda_ms(run, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = KP.pairing_ops_plain("final_exp", a)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_err(o, plain) for o in outs.values())
    fq = min(counts)
    ops_ms = fq * MADS_PER_MONT_MUL / imad_rate * 1e3
    own_ms = counts[0] * MADS_PER_MONT_MUL / imad_rate * 1e3
    moved = 2 * a.numel() * 4
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    # the Miller loop alone: miller on one row
    p, q = affine_pairs(np.random.default_rng(15), 1, dev)
    mask = torch.ones(1, dtype=torch.bool, device=dev)
    for engine in K.ENGINES:
        lib = K.lib("pairing", engine=engine)
        ms[("miller", engine)] = cuda_ms(
            lambda lib=lib: KP._run_miller(lib, p, q, mask), reps=3)
    inv = {}
    x = a[:, 0].contiguous()
    for engine in K.ENGINES:
        lib = K.lib("fp381", engine=engine)
        for op in ("fp_inv", "fp_inv_euclid"):
            inv[(op, engine)] = cuda_ms(
                lambda lib=lib, op=op: KF._run(lib, op, x), reps=3)
    # each cooperative operation's latency: 65 of them in one launch less
    # one, over 64 (the cyclotomic square on a cyclotomic value)
    b = fq12_seeded(np.random.default_rng(14), 1, dev)
    c = cyclotomic_words(b)
    per_op = {}
    for engine in K.ENGINES:
        lib = K.lib("pairing", engine=engine)
        for op, args in (("mul", (a, b)), ("sqr", (a,)), ("cyclo_sqr", (c,))):
            t = [cuda_ms(lambda lib=lib, op=op, args=args, r=r:
                         KP._run_pairing_ops(lib, op, *args, reps=r), reps=3)
                 for r in (1, 65)]
            per_op[f"{op} ({engine})"] = (t[1] - t[0]) / 64 * 1e3
    log(f"[timing] cooperative operation latency, us (65 in one launch "
        f"less 1, over 64): " + json.dumps(
            {k: round(v, 2) for k, v in per_op.items()}))
    log(f"[timing] final exponentiation alone (pairing_ops, 1 value): "
        f"cios {ms[('final_exp', 'cios')]:.3f} ms, mma "
        f"{ms[('final_exp', 'mma')]:.3f} ms; plain "
        f"{plain_ms:.1f} ms; max |kernel - plain| = {err} (tolerance 0); "
        f"bound {max(ops_ms, bytes_ms):.4f} ms ({fq} Fq products)")
    log(f"[timing] Miller loop alone (miller, 1 row): cios "
        f"{ms[('miller', 'cios')]:.3f} ms, mma {ms[('miller', 'mma')]:.3f} ms")
    share = 2 * inv[("fp_inv_euclid", "cios")] / finish_ms * 100
    log(f"[timing] one Fq inversion on one thread (fp381_ops, n = 1): "
        f"Fermat (fp_inv) cios {inv[('fp_inv', 'cios')]:.3f} ms, mma "
        f"{inv[('fp_inv', 'mma')]:.3f} ms; binary Euclid (fp_inv_euclid) "
        f"cios {inv[('fp_inv_euclid', 'cios')]:.3f} ms, mma "
        f"{inv[('fp_inv_euclid', 'mma')]:.3f} ms; finish (A/auto, cios, "
        f"{finish_ms:.3f} ms) runs two Euclid ones: {share:.1f}%")
    if err:
        fail("the final exponentiation alone disagrees with its plain "
             "version")
    return [{"name": "final_exponentiation", "path":
             "inside finish (pairing_ops final_exp, 1 value)",
             "route": "cuda",
             "source": "teku_tpu_torch/ops/kernels/pairing.cuh",
             "replaces": KERNELS["pairing_ops"][1],
             "launches": launches.get("A/auto", {}).get("finish", 0),
             "max_abs_err": err, "ms": ms[("final_exp", "cios")],
             "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": None, "executed_ops_ms": own_ms,
             "mma_ms": ms[("final_exp", "mma")],
             "mma_launches": launches.get("A/mxu", {}).get("finish", 0),
             "fp_inv_ms": inv[("fp_inv", "cios")],
             "fp_inv_euclid_ms": inv[("fp_inv_euclid", "cios")],
             "miller_1_row_ms": ms[("miller", "cios")],
             "miller_1_row_mma_ms": ms[("miller", "mma")],
             "op_latency_us": per_op}]


def profiled(step, active=1):
    """torch.profiler's events (CPU and CUDA) of `active` calls of step(),
    each synchronized, after a call of it unprofiled and one in the
    profiler's warmup: a trace that starts cold can drop the device
    events of its first launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    box = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=active,
                                   repeat=1),
                 on_trace_ready=lambda p: box.append(list(p.events()))
                 ) as prof:
        for _ in range(2 + active):
            step()
            torch.cuda.synchronize()
            prof.step()
    return box[0] if box else []


def device_events(events):
    """The card's activity among profiler events: kernels, memsets and
    copies, not the profiler's own step annotations."""
    return [e for e in events
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


PROFILE_ATTEMPTS = 3
SPIN_PREFIX = 32            # spin kernels ahead of each traced step


def device_trace(step):
    """The device events of one profiled call of step(), from the one of
    PROFILE_ATTEMPTS traces that shows the most.  torch.profiler can drop
    a trace's device events, the first ones first, or all of them (seen
    on the H100 machine), and never adds any; so each traced step starts
    with SPIN_PREFIX short spin kernels (torch.cuda._sleep) for the first
    drops to take, and they are left out of the events."""
    import torch

    def padded():
        for _ in range(SPIN_PREFIX):
            torch.cuda._sleep(1000)
        step()
    best = []
    for _ in range(PROFILE_ATTEMPTS):
        events = [e for e in device_events(profiled(padded))
                  if "spin_kernel" not in e.name]
        if len(events) > len(best):
            best = events
    return best


# kzg_fold's CUDA kernels by part: (name fragment, part)
FOLD_PARTS = (("fold_lane", "fold_lane"), ("g1_sum_pass", "sums"),
              ("fold_pair", "pair blocks"), ("fold_verdict", "verdict block"))


def fold_split(fn):
    """Device us of each part of one call of fn (kzg_fold; torch.profiler)
    and its CUDA launches; None where the profiler shows no device
    activity."""
    kernels = device_trace(fn)
    if not kernels:
        return None
    parts = {}
    for e in kernels:
        part = next((p for key, p in FOLD_PARTS if key in e.name), "other")
        parts[part] = (parts.get(part, 0.0)
                       + e.time_range.end - e.time_range.start)
    parts["launches"] = len(kernels)
    return parts


def launch_split(fn, calls=50):
    """(host us a call, device us a call, CUDA launches a call, their
    names) of fn: the host clock around `calls` calls unsynchronized, and
    torch.profiler's device events over `calls` more (`device_trace`) --
    kernels, memsets and copies alike, not the profiler's annotations
    (fn's inputs are on the card already; None where the profiler shows
    no device activity)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()

    def step():
        for _ in range(calls):
            fn()
    kernels = device_trace(step)
    if not kernels:
        return host_us, None, None, []
    dev_us = sum(e.time_range.end - e.time_range.start
                 for e in kernels) / calls
    return (host_us, dev_us, len(kernels) / calls,
            sorted({e.name[:60] for e in kernels}))


def row11_rows(imad_rate, launches, dev):
    """Row 11 timed alone: fp_mont at n = 256 and 2^20 and fr_mont at
    2^20 on both builds (CUDA events, median of 3), the plain digit
    product (host clock, synchronized; chunks of 2^16 pairs), the bound
    from the CIOS product's work (the products the host build counts: 1
    a pair, 576 / 256 IMADs, against its bytes) and the mma kernel's own
    count (int8 MACs, 2 ops each, over the dense int8 rate)."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import _build
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops.kernels import fp381 as KF
    rng = np.random.default_rng(1111)
    mxu_paths = {g: sum(c.values()) for g, c in launches.items()
                 if group_engine(g) == "mma"}
    total = sum(mxu_paths.values())
    log(f"[row11] mma-engine launches per mxu-force path (each runs the "
        f"row-11 product): {json.dumps(mxu_paths)}")
    host_lib = _build.library("fp381", host=True)
    rows = []
    for op, n in ROW11_SIZES:
        nw = ROW11_FIELDS[op][0]
        a = row11_words(rng, op, n).to(dev)
        b = row11_words(rng, op, n).to(dev)
        run = {e: (lambda e=e: KF._run(K.lib("fp381", engine=e), op, a, b))
               for e in ("cios", "mma")}
        outs = {e: f() for e, f in run.items()}
        ms = {e: cuda_ms(f, reps=3) for e, f in run.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with K.plain_engine("mma"):
            plain = torch.cat([
                KF.fp381_ops_plain(op, a[i:i + PLAIN_CHUNK],
                                   b[i:i + PLAIN_CHUNK])
                for i in range(0, n, PLAIN_CHUNK)])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_err(outs["mma"], outs["cios"]),
                  max_err(outs["mma"], plain))
        counter = host_lib.fp381_mul_count if op == "fp_mont" \
            else host_lib.fr_mul_count
        before = counter()
        KF._run(host_lib, op, a[:1].cpu(), b[:1].cpu())
        per = counter() - before                 # products per element
        mads = MADS_PER_MONT_MUL if op == "fp_mont" else MADS_PER_FR_MUL
        ops_ms = n * per * mads / imad_rate * 1e3
        bytes_ms = n * 3 * 4 * nw / HBM_BYTES_PER_S * 1e3
        own_ms = n * per * MACS_PER_MMA_PRODUCT * 2 / INT8_OPS_PER_S * 1e3
        log(f"[row11] {op} n = {n}: mma {ms['mma']:.4f} ms, cios "
            f"{ms['cios']:.4f} ms, plain {plain_ms:.1f} ms; max |mma - "
            f"cios|, |mma - plain| = {err}; bound {max(ops_ms, bytes_ms):.4f}"
            f" ms ({per} products an element x {mads} IMADs, {n * 12 * nw}"
            f" bytes); the mma kernel's own count {own_ms:.4f} ms "
            f"({MACS_PER_MMA_PRODUCT} int8 MACs a product)")
        if err:
            fail(f"row 11: {op} at n = {n} disagrees")
        rows.append({"name": "mont_mul_mxu" if op == "fp_mont"
                     else "fr_mont_mul_mxu",
                     "path": f"row 11 alone (fp381_ops {op}, n = {n})",
                     "route": "cuda", "source": ROW11_SOURCE,
                     "replaces": ROW11, "launches": total,
                     "max_abs_err": err, "ms": ms["mma"],
                     "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "library_ms": None,
                     "executed_ops_ms": own_ms, "cios_ms": ms["cios"],
                     "mma_ms": ms["mma"], "mma_launches": total})
    return rows


# the groups whose recorded kernel inputs hold each engine against the
# other (A on both scalars paths, B, the mesh on A and B, the legacy mesh,
# K6, K9)
ENGINE_PARITY_GROUPS = ("A/auto", "A/pippenger", "B/auto", "mesh A/auto",
                        "mesh B/auto", "legacy A", "kzg", "kzg9")
# the kernels on pairing.cuh's cooperative routines that the engine parity
# also holds against their plain versions on every path that runs them
COOP_ROWS = ("miller", "kzg_fold")
# the kernels on wcoop.cuh's warps (a warp a row or lane), held against
# their plain versions on both builds on every verify group that ran them:
# A on its three scalars paths, B, the mesh groups, mxu-force
WARP_ROWS = ("h2c", "prepare")


def input_key(name, args):
    """A kernel call's inputs as a key: equal inputs, one plain run."""
    import hashlib
    digest = hashlib.sha256()
    for a in args:
        digest.update(repr((tuple(a.shape), a.dtype)).encode())
        digest.update(a.cpu().numpy().tobytes())
    return name, digest.hexdigest()


def phase_engine_parity(recorder):
    """Every kernel on the mma build against the cios build, word for
    word, on the first inputs each group's main-path run gave it; miller
    and kzg_fold (on ENGINE_PARITY_GROUPS) and h2c and prepare (on every
    group) on both builds against their plain versions too."""
    import torch
    kr, km, pr = kernel_runner(), kernel_runner(engine="mma"), plain_runner()
    bad, held, plain_of = [], {}, {}
    for (group, name), args in sorted(recorder.args.items()):
        if group not in ENGINE_PARITY_GROUPS and name not in WARP_ROWS:
            continue
        cios, mma = as_tuple(kr(name, *args)), as_tuple(km(name, *args))
        pairs = [("mma", "cios", mma, cios)]
        if name in COOP_ROWS + WARP_ROWS:
            key = input_key(name, args)
            if key not in plain_of:
                plain_of[key] = as_tuple(pr(name, *args))
            plain = plain_of[key]
            pairs += [("cios", "plain", cios, plain),
                      ("mma", "plain", mma, plain)]
            held.setdefault(name, []).append(group)
        errs = [(x, y, max(max_err(a, b) for a, b in zip(u, v)))
                for x, y, u, v in pairs]
        torch.cuda.synchronize()
        log(f"[engines] {name:14s} {group:12s} " + ", ".join(
            f"max |{x} - {y}| = {e}" for x, y, e in errs)
            + " (tolerance 0)")
        if any(e for _, _, e in errs):
            bad.append((group, name))
    if bad:
        fail(f"the mma build, the cios build and the plain version "
             f"disagree on {bad}")
    for name in WARP_ROWS:
        inputs = sum(k[0] == name for k in plain_of)
        log(f"[engines] {name} held against its plain version on both "
            f"builds on {held.get(name, [])} ({inputs} distinct inputs)")
    missing = sorted(set(COOP_ROWS + WARP_ROWS) - set(held))
    if missing:
        fail(f"{missing} ran on no path")


def lane_rows(plan):
    """Each lane's Miller row in a single-device dispatch plan (padding
    lanes: row 0): the per-lane H(m) index of the legacy path."""
    import numpy as np
    rows = np.zeros(plan["pk_present"].shape[0], dtype=np.int32)
    gi = plan["group_idx"]
    for r, c in zip(*np.nonzero(plan["group_present"])):
        rows[gi[r, c]] = r
    return rows


def mesh_parity(semis, plan, pk_jac, sig_jac, dev, report):
    """The mesh kernels against their plain versions at workload A's
    shapes (4 shards: 2 rows and 64 lanes each); `plan` is A's
    single-device plan.  Returns the aggregate_points inputs (G1, G2)
    for the timing phase."""
    import torch
    from teku_tpu_torch.ops import msm
    from teku_tpu_torch.ops.provider import TorchBls12381
    from teku_tpu_torch.parallel import make_mesh
    kr, pr = kernel_runner(), plain_runner()

    def check(label, name, *args):
        report(label, [max_err(a, b) for a, b in zip(
            as_tuple(kr(name, *args)), as_tuple(pr(name, *args)))])

    mprov = TorchBls12381(device=dev, mesh=make_mesh(
        devices=[dev] * SHARDS, advertise=False))
    with msm.force("ladder"):
        mplan = mprov.plan(semis, randomize=True)
    draws = torch.from_numpy(mplan["hm_plan"][3]).to(dev)
    hm = kr("h2c", draws[:, 0:2].contiguous(), draws[:, 2:4].contiguous())
    row_gather = torch.from_numpy(mplan["row_gather"]).to(dev)
    check("gather_hm/A", "gather_hm", hm, row_gather)
    bad = row_gather.clone()
    bad[1], bad[5] = hm.shape[0], -1
    check("gather_hm/bad", "gather_hm", hm, bad)
    if bool(kr("gather_hm", hm, bad)[1].item()):
        fail("gather_hm accepted an index out of range")
    # 256 lanes with infinity keys (lanes 3, 200) and signatures (3, 77)
    pk_inf, sig_inf = pk_jac.clone(), sig_jac.clone()
    pk_inf[[3, 200], 2] = 0
    sig_inf[[3, 77], 2] = 0
    r = torch.from_numpy(mplan["r"]).to(dev)
    check("scalars/A", "scalars", pk_inf, sig_inf, r)
    pk_r, wsig = kr("scalars", pk_inf, sig_inf, r)
    check("lane_affine/A", "lane_affine", pk_r)
    aff = kr("lane_affine", pk_r)
    # a shard's partials: 2 Miller rows and 64 weighted signatures, and an
    # all-padding shard (rows ONE, signatures infinity)
    lanes = pk_jac.shape[0] // SHARDS
    agg = aff[:2].contiguous()
    hm_rows = kr("gather_hm", hm, row_gather)[0]
    ml = kr("miller", agg, hm_rows[:2].contiguous(),
            torch.ones(2, dtype=torch.bool, device=dev))
    check("shard_partials/A", "shard_partials", ml, wsig[:lanes].contiguous())
    ml_one = kr("miller", agg, hm_rows[:2].contiguous(),
                torch.zeros(2, dtype=torch.bool, device=dev))
    inf = wsig[:lanes].clone()
    inf[:, 2] = 0
    check("shard_partials/pad", "shard_partials", ml_one, inf)
    prod, ssum = kr("shard_partials", ml_one, inf)
    one = torch.zeros_like(prod)
    one[0, 0, 0] = 1
    if not torch.equal(prod, one) or bool(ssum[0, 2].any()):
        fail("an all-padding shard did not give ONE and infinity")
    # aggregate_points over A's 256 lanes, absent where the key is infinity
    present = torch.ones(pk_jac.shape[0], dtype=torch.bool, device=dev)
    present[[3, 200, 201]] = False
    g2_pts = kr("gather_hm", hm, torch.from_numpy(lane_rows(plan)).to(dev))[0]
    args = {"g1": (aff, present), "g2": (g2_pts, present)}
    for group, a in args.items():
        check(f"aggregate/{group}", "aggregate_points", *a)
    return args


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


def group_engine(group: str) -> str:
    """The kernel engine of a verify group: the /mxu groups run on mma."""
    return "mma" if group.endswith("/mxu") else "cios"


def engine_launches(group, engine, names):
    """The launches of `names` on `engine` since the counters were zeroed;
    fails if the other engine launched anything."""
    from teku_tpu_torch.ops import kernels as K
    counts, other = ((K.MMA_LAUNCHES, K.LAUNCHES) if engine == "mma"
                     else (K.LAUNCHES, K.MMA_LAUNCHES))
    stray = {k: v for k, v in other.items() if v}
    if stray:
        fail(f"{group}: the other engine launched {stray}")
    return {name: counts[name] for name in names}


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
            ("B, one swapped signature", swap_sig(batch_b, 3, 4), False)]),
        # the same batches on the mma engine (row 11): a provider built
        # under mont path mxu-force
        ("A/mxu", "auto", "ladder", [
            ("A under mxu-force", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 5, 6), False)]),
        ("B/mxu", "auto", "ladder", [
            ("B under mxu-force", batch_b, True),
            ("B, one swapped signature", swap_sig(batch_b, 3, 4), False)])]
    provs = {"cios": TorchBls12381(device=dev),
             "mma": TorchBls12381(device=dev, mont_path="mxu-force")}
    if (provs["cios"].mont_path, provs["mma"].mont_path) != ("vpu", "mxu"):
        fail(f"mont paths resolved to {provs['cios'].mont_path} and "
             f"{provs['mma'].mont_path}, expected vpu and mxu")
    launches = {}
    for group, path, resolved, cases in groups:
        engine = group_engine(group)
        prov = provs[engine]
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
        launches[group] = engine_launches(group, engine, BLS_KERNELS)
        for label, got, expect, dt, ran in results:
            log(f"[verify] {group} {label}: {got} (expected {expect}) on "
                f"{ran} in {dt * 1e3:.1f} ms")
        log(f"[verify] {group} {engine} launches: "
            f"{json.dumps(launches[group])}")
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
    # warm repeats of the valid A batch on each path, interleaved; "mxu"
    # is auto on the mma engine
    warm = {"auto": [], "ladder": [], "pippenger": [], "mxu": []}
    for _ in range(WARM_REPS):
        for path, times in warm.items():
            prov = provs["mma" if path == "mxu" else "cios"]
            with msm.force("auto" if path == "mxu" else path):
                t0 = time.perf_counter()
                got = prov.batch_verify(batch_a)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm A under {path} verified {got}")
    for path, times in warm.items():
        log(f"[verify] A warm under {path}, {WARM_REPS} repeats: "
            f"{spread(times)}")
    for path, base in (("auto", "ladder"), ("pippenger", "ladder"),
                       ("mxu", "auto")):
        diffs = [a - b for a, b in zip(warm[path], warm[base])]
        log(f"[verify] A warm, {path} - {base} per interleaved pair: "
            f"{spread(diffs, signed=True)}")
    for engine, prov in provs.items():
        log(f"[verify] msm dispatches ({engine}): "
            f"{json.dumps(prov.msm_dispatches)}")
    return launches


def phase_mesh(signer, dev, recorder):
    """The group-aligned mesh on both scalars paths and the legacy
    lane-sharded form, on a virtual 4-shard mesh of the one card, each
    held against a single-device provider; returns {group: launches}."""
    import numpy as np
    import torch
    from teku_tpu_torch.ops import kernels as K
    from teku_tpu_torch.ops import msm
    from teku_tpu_torch.ops.kernels import shard as KSH
    from teku_tpu_torch.ops.provider import TorchBls12381
    from teku_tpu_torch.parallel import ShardedVerifier, make_mesh
    mesh = make_mesh(devices=[dev] * SHARDS)
    log(f"[mesh] {SHARDS} shards on {[str(d) for d in mesh.devices]}")
    batch_a, batch_b = workload_a(signer), workload_b(signer)
    groups = [
        ("mesh A/auto", "auto", "ladder", [
            ("A", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 5, 6), False)]),
        ("mesh A/pippenger", "pippenger", "pippenger", [
            ("A", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 9, 10), False)]),
        ("mesh B/auto", "auto", "ladder", [
            ("B", batch_b, True),
            ("B, one swapped signature", swap_sig(batch_b, 3, 4), False)]),
        ("mesh A/mxu", "auto", "ladder", [
            ("A under mxu-force", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 5, 6), False)])]
    meshes = {"cios": TorchBls12381(device=dev, mesh=mesh),
              "mma": TorchBls12381(device=dev, mesh=mesh,
                                   mont_path="mxu-force")}
    single = TorchBls12381(device=dev)
    names = BLS_KERNELS + MESH_KERNELS
    launches = {}
    for group, path, resolved, cases in groups:
        engine = group_engine(group)
        meshed = meshes[engine]
        torch.cuda.synchronize()
        K.reset_launches()
        recorder.group = group
        results = []
        with msm.force(path):
            for label, triples, expect in cases:
                t0 = time.perf_counter()
                handle = meshed.begin_batch_verify(triples)
                got = handle.result()
                dt = time.perf_counter() - t0
                results.append((label, triples, expect, got,
                                handle.lane_ok(), dt))
        recorder.group = None
        launches[group] = engine_launches(group, engine, names)
        with msm.force(path):
            for label, triples, expect, got, lane_ok, dt in results:
                ref = single.begin_batch_verify(triples)
                log(f"[mesh] {group} {label}: {got} (expected {expect}, "
                    f"single device {ref.result()}) in {dt * 1e3:.1f} ms")
                if got is not expect or ref.result() is not expect:
                    fail(f"{group} batch '{label}' verified {got} on the "
                         f"mesh, {ref.result()} on one device, expected "
                         f"{expect}")
                if not np.array_equal(lane_ok, ref.lane_ok()):
                    fail(f"{group} batch '{label}': lane_ok differs from "
                         f"the single-device dispatch's")
                if (engine == "cios" and meshed.h2c_dispatch_count
                        != single.h2c_dispatch_count):
                    fail(f"{group}: h2c_dispatch_count "
                         f"{meshed.h2c_dispatch_count} on the mesh, "
                         f"{single.h2c_dispatch_count} on one device")
        log(f"[mesh] {group} {engine} launches: "
            f"{json.dumps(launches[group])}")
        n = len(cases)
        other = SCALARS["ladder" if resolved == "pippenger" else "pippenger"]
        want = {"gather_hm": n, "shard_partials": SHARDS * n, "finish": n,
                "prepare": SHARDS * n, SCALARS[resolved]: SHARDS * n,
                "miller": SHARDS * n, other: 0, "scalars": 0,
                "lane_affine": 0}
        for name, count in want.items():
            if launches[group][name] != count:
                fail(f"{group}: {name} launched {launches[group][name]} "
                     f"times, expected {count}")
    meshed = meshes["cios"]
    log(f"[mesh] h2c dispatches: mesh {meshed.h2c_dispatch_count}, one "
        f"device {single.h2c_dispatch_count}; dedup counters: lanes "
        f"{meshed.h2c_lanes} / {single.h2c_lanes}, unique "
        f"{meshed.h2c_unique} / {single.h2c_unique}")
    # the legacy lane-sharded form on A: 64 lanes a shard, a Miller row
    # per lane; per-lane H(m) from the batch's unique rows
    sharded = ShardedVerifier(mesh)
    legacy = []
    for label, triples, expect in (
            ("A", batch_a, True),
            ("A, one swapped signature", swap_sig(batch_a, 11, 12), False)):
        with msm.force(msm.resolve(sharded=True)):
            plan = single.plan([single.prepare_batch_verify(t)
                                for t in triples], randomize=True)
        hm_rows = single._hm_device(plan["hm_plan"])
        hm, in_range = KSH.gather_hm(hm_rows, single._to_dev(
            lane_rows(plan)))
        if not bool(in_range.item()):
            fail("legacy inputs: an H(m) row index out of range")
        args = [single._to_dev(plan[k]) if k != "hm" else hm
                for k in ShardedVerifier.KEYS]
        legacy.append((label, triples, expect, args))
    torch.cuda.synchronize()
    K.reset_launches()
    recorder.group = "legacy A"
    results = []
    for label, triples, expect, args in legacy:
        t0 = time.perf_counter()
        ok, lane_ok = sharded(*args)
        got = bool(ok.item()) and bool(lane_ok.all())
        results.append((label, triples, expect, got,
                        time.perf_counter() - t0))
    recorder.group = None
    launches["legacy A"] = engine_launches("legacy A", "cios", names)
    for label, triples, expect, got, dt in results:
        ref = single.batch_verify(triples)
        log(f"[mesh] legacy A {label}: {got} (expected {expect}, single "
            f"device {ref}) in {dt * 1e3:.1f} ms")
        if got is not expect or ref is not expect:
            fail(f"legacy batch '{label}' verified {got}, expected {expect}")
    log(f"[mesh] legacy A launches: {json.dumps(launches['legacy A'])}")
    n = len(legacy)
    for name, count in {"scalars": SHARDS * n, "lane_affine": SHARDS * n,
                        "shard_partials": SHARDS * n, "finish": n,
                        "scalars_group": 0, "scalars_msm": 0,
                        "gather_hm": 0}.items():
        if launches["legacy A"][name] != count:
            fail(f"legacy A: {name} launched {launches['legacy A'][name]} "
                 f"times, expected {count}")
    # warm A on the mesh against warm A on one device, interleaved
    warm = {"mesh": [], "single": []}
    for _ in range(WARM_REPS):
        for key, prov in (("mesh", meshed), ("single", single)):
            t0 = time.perf_counter()
            got = prov.batch_verify(batch_a)
            torch.cuda.synchronize()
            warm[key].append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm A on {key} verified {got}")
    for key, times in warm.items():
        log(f"[mesh] A warm under auto on {key}, {WARM_REPS} repeats: "
            f"{spread(times)}")
    diffs = [a - b for a, b in zip(warm["mesh"], warm["single"])]
    log(f"[mesh] A warm, mesh - single per interleaved pair: "
        f"{spread(diffs, signed=True)}")
    return launches


def median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def gather_regimes(signer, dev, reps=20):
    """gather_hm against torch.index_select on mesh A's inputs, us a call
    as (gather_hm, index_select) per regime.  "batch_host" and
    "batch_device": inside warm mesh A batches under auto, as the mesh
    dispatch calls it, each batch's handle alive (it holds in_range) and
    index_select run on the same inputs beside each call, its output held
    as long, the two in alternating order; the host clock around each
    call over `reps` batches (median), and torch.profiler's device time
    of the kernels each one launched over 5 more (`profiled`), each call
    in a range of its own (mean; None where the profiler shows none).  Alone, on the
    first batch call's inputs: "one_call", one call (CUDA events, median
    of 3); "held" and "dropped", a call in 100 back-to-back calls with the
    outputs held (each call makes new ones) and dropped, 7 times, the two
    taking turns (medians)."""
    import torch
    from torch.profiler import record_function
    from teku_tpu_torch.ops.kernels import shard as KSH
    from teku_tpu_torch.ops.provider import TorchBls12381
    from teku_tpu_torch.parallel import make_mesh
    prov = TorchBls12381(device=dev, mesh=make_mesh(devices=[dev] * SHARDS))
    batch = workload_a(signer)
    orig = KSH.gather_hm
    host = {"gather_hm": [], "index_select": []}
    held, first, ranges = [], [], []

    def timed(hm, idx, **kw):
        first.append((hm, idx))
        order = [("gather_hm", lambda: orig(hm, idx, **kw)),
                 ("index_select", lambda: torch.index_select(hm, 0, idx))]
        out = None
        for name, fn in order[::-1] if len(first) % 2 else order:
            if ranges:                  # profiled: a range, no host time
                with record_function(f"regime::{name}"):
                    got = fn()
            else:
                t0 = time.perf_counter()
                got = fn()
                host[name].append((time.perf_counter() - t0) * 1e6)
            if name == "gather_hm":
                out = got
            else:
                held.append(got)
        return out

    handles = []

    def run(n):
        for _ in range(n):
            handle = prov.begin_batch_verify(batch)
            if handle.result() is not True:
                fail("gather_regimes: warm mesh A did not verify")
            handles.append(handle)

    KSH.gather_hm = timed
    try:
        run(3)
        for times in host.values():
            times.clear()
        run(reps)
        ranges.append(True)
        events = profiled(lambda: run(1), active=5)
    finally:
        KSH.gather_hm = orig

    def device_us(name):
        total = 0.0
        for e in events:
            if e.name == f"regime::{name}":
                t = getattr(e, "device_time_total", None)
                total += e.cuda_time_total if t is None else t
        return total / 5 if total else None

    hm, idx = first[0]
    gather = (lambda: orig(hm, idx))                    # noqa: E731
    library = (lambda: torch.index_select(hm, 0, idx))  # noqa: E731
    keep = []
    held_ms = interleaved_ms((lambda: keep.append(gather()),
                              lambda: keep.append(library())),
                             reps=7, calls=100)
    keep.clear()
    dropped_ms = interleaved_ms((gather, library), reps=7, calls=100)
    out = {"batch_host": (median(host["gather_hm"]),
                          median(host["index_select"])),
           "batch_device": (device_us("gather_hm"),
                            device_us("index_select")),
           "one_call": (cuda_ms(gather, reps=3) * 1e3,
                        cuda_ms(library, reps=3) * 1e3),
           "held": (held_ms[0] * 1e3, held_ms[1] * 1e3),
           "dropped": (dropped_ms[0] * 1e3, dropped_ms[1] * 1e3)}
    for regime, (g, lib) in out.items():
        under = ("not measured" if g is None or lib is None
                 else "yes" if g <= lib else "no")
        log(f"[gather] {regime:12s} gather_hm "
            f"{'not measured' if g is None else f'{g:.2f}'} us, "
            f"index_select {'not measured' if lib is None else f'{lib:.2f}'}"
            f" us: gather_hm at or under index_select: {under}")
    return out


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
        # K9's kernel inputs are a group of their own (phase_engine_parity)
        recorder.group = "kzg9" if label.startswith("9 blobs") else "kzg"
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        results.append((label, got, expect, time.perf_counter() - t0))
    recorder.group = None
    launches = engine_launches("kzg", "cios", KZG_KERNELS)
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
    # K6 on the mma engine (row 11): a backend built under mxu-force
    mxu_backend = TorchKzg(device=dev, mont_path="mxu-force")
    HK.set_backend(mxu_backend)
    torch.cuda.synchronize()
    K.reset_launches()
    recorder.group = "kzg/mxu"
    results = []
    for label, (bl, cm, pr), expect in (
            ("6 blobs under mxu-force", (blobs[six], cms[six], prs[six]),
             True),
            ("6 blobs, proofs swapped", (blobs[six], cms[six],
                                         prs[1:6] + prs[:1]), False)):
        t0 = time.perf_counter()
        got = HK.verify_blob_kzg_proof_batch(bl, cm, pr)
        torch.cuda.synchronize()
        results.append((label, got, expect, time.perf_counter() - t0))
    recorder.group = None
    launches_mxu = engine_launches("kzg/mxu", "mma", KZG_KERNELS)
    for label, got, expect, dt in results:
        log(f"[kzg] {label}: {got} (expected {expect}, as the cios "
            f"engine's) in {dt * 1e3:.1f} ms")
        if got is not expect:
            fail(f"kzg case '{label}' gave {got} on the mma engine")
    log(f"[kzg] mma launches: {json.dumps(launches_mxu)}")
    for name in ("g1_validate", "kzg_eval", "kzg_fold"):
        if launches_mxu[name] < 1:
            fail(f"kernel {name} was not launched on the K6 mxu path")
    # warm K6 on each engine, interleaved
    warm = {"cios": (backend, []), "mma": (mxu_backend, [])}
    for _ in range(WARM_REPS):
        for engine, (be, times) in warm.items():
            HK.set_backend(be)
            t0 = time.perf_counter()
            got = HK.verify_blob_kzg_proof_batch(blobs[six], cms[six],
                                                 prs[six])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if got is not True:
                fail(f"warm K6 on {engine} verified {got}")
    for engine, (_, times) in warm.items():
        log(f"[kzg] warm 6-blob batch on {engine}, {WARM_REPS} repeats "
            f"interleaved: {spread(times)}")
    diffs = [a - b for a, b in zip(warm["mma"][1], warm["cios"][1])]
    log(f"[kzg] warm K6, mma - cios per interleaved pair: "
        f"{spread(diffs, signed=True)}")
    HK.set_backend(None)
    return {"kzg": launches, "kzg/mxu": launches_mxu}


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
        from teku_tpu_torch.ops.kernels import shard as KSH
        self.group = None
        self.args = {}
        for mod, name in ((KD, "g1_validate"), (KD, "prepare"), (KH, "h2c"),
                          (KS, "scalars_group"), (KM, "scalars_msm"),
                          (KP, "miller"), (KP, "finish"), (KK, "kzg_eval"),
                          (KK, "kzg_fold"), (KK, "kzg_msm"),
                          (KSH, "gather_hm"), (KS, "scalars"),
                          (KSH, "lane_affine"), (KSH, "shard_partials")):
            self._wrap(mod, name)

    def _wrap(self, mod, name):
        orig = getattr(mod, name)

        def wrapper(*args, **kwargs):
            key = (self.group, name)
            if self.group is not None and key not in self.args:
                self.args[key] = args
            return orig(*args, **kwargs)
        setattr(mod, name, wrapper)


def cuda_ms(fn, reps: int, calls: int = 1) -> float:
    """Median over reps of the CUDA-event time of `calls` back-to-back
    calls of fn, a call (calls > 1: the steady state of a call whose time
    is its host path)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def interleaved_ms(fns, reps: int, calls: int):
    """cuda_ms of each fn (a call in `calls` back-to-back calls), the fns
    taking turns over reps; the median of each."""
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn, reps=1, calls=calls))
    return [sorted(t)[len(t) // 2] for t in times]


def nbytes(xs) -> int:
    import torch
    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


# (kernel, group whose first call it is timed on): workload A's shapes
# (prepare, h2c and miller also at B's: 64 lanes of 128 keys, 64 rows;
# finish on both wsig widths: 1 lane from
# scalars_msm, 256 from scalars_group) and the KZG path's (eval on the
# padded 6-blob batch, the fold's 32 lanes, the msm's 4096, validation of
# its 16-lane miss bucket)
TIMED = [("g1_validate", "A/auto"), ("prepare", "A/auto"), ("h2c", "A/auto"),
         ("prepare", "B/auto"), ("h2c", "B/auto"),
         ("scalars_group", "A/auto"), ("scalars_msm", "A/pippenger"),
         ("miller", "A/auto"), ("miller", "B/auto"), ("finish", "A/auto"),
         ("finish", "A/pippenger"), ("gather_hm", "mesh A/auto"),
         ("shard_partials", "mesh A/auto"), ("scalars", "legacy A"),
         ("lane_affine", "legacy A"), ("aggregate_points", "parity g1"),
         ("aggregate_points", "parity g2"), ("g1_validate", "kzg"),
         ("kzg_eval", "kzg"), ("kzg_fold", "kzg"), ("kzg_msm", "kzg")]
GROUP_PATH = {"A/auto": "ladder", "A/pippenger": "pippenger", "kzg": "kzg",
              "B/auto": "ladder (B)",
              "mesh A/auto": "mesh", "legacy A": "legacy mesh",
              "parity g1": "parity (G1)", "parity g2": "parity (G2)"}
# the mxu-force twin of a path (the mma engine's launches)
MXU_GROUP = {"A/auto": "A/mxu", "B/auto": "B/mxu", "mesh A/auto": "mesh A/mxu",
             "kzg": "kzg/mxu"}
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


def lane_affine_least_work(pk_r):
    """Fq products that Jacobian -> affine of these lanes needs at least:
    one batched inversion of the nonzero z (3 (m - 1) products and one
    inverse) and 4 products per such lane (z^-2, z^-3, x z^-2, y z^-3);
    an infinity lane needs none."""
    from teku_tpu_torch.crypto.bls.constants import P
    m = int(pk_r[:, 2].ne(0).any(dim=1).sum())
    return 3 * (m - 1) + pow_chain(P) + 4 * m if m else 0


def plain_products(step):
    """Fq products that step(), plain PyTorch code on host tensors,
    executes: each element of each Montgomery product or square of
    limbs.py it calls."""
    import math
    import torch
    from teku_tpu_torch.ops import limbs
    count = [0]
    real = limbs.mont_mul, limbs.mont_sqr

    def counted(fn):
        def run(*xs):
            count[0] += math.prod(torch.broadcast_shapes(
                *(x.shape for x in xs))[:-1])
            return fn(*xs)
        return run
    limbs.mont_mul, limbs.mont_sqr = (counted(fn) for fn in real)
    try:
        step()
    finally:
        limbs.mont_mul, limbs.mont_sqr = real
    return count[0]


def pairing_least_work(agg, hm, x):
    """{routine: (the host build's Fq products, the plain version's)} for
    one Miller row (agg, hm: one affine pair), one final exponentiation
    and one Fq12 product (x: one Fq12 value).  The plain version follows
    the reference's formulas (a Karatsuba Fq12 product of 54 Fq products,
    a Granger-Scott square of 39), the cooperative routines their own (a
    product over the w basis of 108, a cyclotomic square of 18), each
    count with the loads and stores of its words; the least work of each
    routine is the fewer."""
    import torch
    from teku_tpu_torch.ops.kernels import pairing as KP
    agg, hm, x = agg[:1].cpu(), hm[:1].cpu(), x[:1].cpu()
    one = torch.ones(1, dtype=torch.bool)
    calls = {"miller": ("miller", (agg, hm, one)),
             "final_exp": ("pairing_ops", ("final_exp", x)),
             "mul": ("pairing_ops", ("mul", x, x))}
    pr = plain_runner()
    return {k: (host_products("pairing", name, args)[0],
                plain_products(lambda name=name, args=args: pr(name, *args)))
            for k, (name, args) in calls.items()}


def host_products(stem, name, args):
    """(Fq, Fr) products the host C++ build of the kernel executes."""
    from teku_tpu_torch.ops import _build
    host_lib = _build.library(stem, host=True)
    fr_count = getattr(host_lib, "fr_mul_count", lambda: 0)
    before = (host_lib.fp381_mul_count(), fr_count())
    kernel_runner(host=True)(name, *[a.cpu() if hasattr(a, "cpu") else a
                                     for a in args])
    return (host_lib.fp381_mul_count() - before[0],
            fr_count() - before[1])


def phase_timing(recorder, launches, dev, regimes):
    import torch
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    imad_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    log(f"[timing] {props.multi_processor_count} SMs at max {clock_mhz:.0f} "
        f"MHz: {imad_rate / 1e12:.2f} T IMAD/s; HBM {HBM_BYTES_PER_S / 1e12} TB/s")
    kr, pr = kernel_runner(), plain_runner()
    km = kernel_runner(engine="mma")
    # the least work of the pairing routines (pairing_least_work), and
    # what the cooperative build executes beyond it
    agg, hm, _ = recorder.args[("A/pippenger", "miller")]
    ml, _ = recorder.args[("A/pippenger", "finish")]
    counts = pairing_least_work(agg, hm, ml)
    least = {k: min(v) for k, v in counts.items()}
    extra = {k: v[0] - least[k] for k, v in counts.items()}
    # kzg_fold's two Miller loops, their product and one final
    # exponentiation
    pairing_products = (2 * least["miller"] + least["mul"]
                        + least["final_exp"])
    log(f"[timing] Fq products (host build of pairing.cu, plain version): "
        + ", ".join(f"{k} {v[0]}, {v[1]}" for k, v in counts.items())
        + f"; 2 Miller loops + 1 product + 1 final exponentiation, the "
        f"least of each: {pairing_products}")
    rows = []
    for name, group in TIMED:
        stem, replaces = KERNELS[name]
        args = recorder.args[(group, name)]
        # aggregate_points has no caller on the path (nor in the
        # reference): its row's launches are the path's, 0
        launched = launches.get(group, {}).get(name, 0)
        kout = as_tuple(kr(name, *args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pout = as_tuple(pr(name, *args))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_err(a, b) for a, b in zip(kout, pout))
        # gather_hm, whose time is its host path, and the one PyTorch
        # call that computes the same function (hm[idx]; the kernel also
        # checks the indices): a call in 100 back-to-back calls with the
        # outputs held, as the mesh dispatch holds them (gather_regimes)
        timer = ({"reps": 7, "calls": 100} if name == "gather_hm"
                 else {"reps": 3})
        library_ms = None
        if name == "gather_hm":
            ms, library_ms = (t / 1e3 for t in regimes["held"])
        else:
            ms = cuda_ms(lambda: kr(name, *args), **timer)
        # the same kernel on the mma engine: its launches on the path's
        # mxu-force twin, its time, and its words against the cios build
        mma_err = max(max_err(a, b) for a, b in zip(
            as_tuple(km(name, *args)), kout))
        if name == "gather_hm":
            held = []               # the outputs held, as the mesh does
            mma_ms = cuda_ms(lambda: held.append(km(name, *args)), **timer)
            held.clear()
        else:
            mma_ms = cuda_ms(lambda: km(name, *args), **timer)
        mma_launched = launches.get(MXU_GROUP.get(group), {}).get(name, 0)
        fq, fr = host_products(stem, name, args)
        executed_ms = ((fq * MADS_PER_MONT_MUL + fr * MADS_PER_FR_MUL)
                       / imad_rate * 1e3)
        moved = nbytes(args) + nbytes(kout)
        if name.startswith("kzg_"):
            fq, fr, moved = kzg_least_work(name, args, pairing_products)
        elif name == "miller":
            fq -= extra["miller"] * int(args[2].sum())
        elif name == "finish":
            # one Miller loop, one product, one final exponentiation on
            # the block (the sum of A's weighted signatures is finite)
            fq -= extra["miller"] + extra["mul"] + extra["final_exp"]
        elif name == "lane_affine":
            fq, fr = lane_affine_least_work(args[0]), 0
        elif name in WARP_ROWS:
            # the fewer of the warp build's products and the plain
            # version's (the reference's formulas)
            fq = min(fq, plain_products(lambda: pr(name, *args)))
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
            f"own products {executed_ms:.4f} ms"
            + ("" if library_ms is None else f"; library {library_ms:.4f} ms")
            + f"; mma engine {mma_ms:.3f} ms, max |mma - cios| = {mma_err}, "
            f"{mma_launched} mma launches")
        rows.append({"name": name, "path": GROUP_PATH[group], "route": "cuda",
                     "source": f"teku_tpu_torch/ops/kernels/{stem}.cu",
                     "replaces": (KZG_REPLACES.get(name, replaces)
                                  if group == "kzg" else replaces),
                     "launches": launched,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": library_ms, "executed_ops_ms": executed_ms,
                     "mma_ms": mma_ms, "mma_launches": mma_launched,
                     "mma_max_abs_err": mma_err})
        if err != 0:
            fail(f"{name} disagrees with its plain version at {group}'s "
                 f"shapes")
        if mma_err != 0:
            fail(f"{name}'s mma build disagrees with its cios build at "
                 f"{group}'s shapes")
        if name == "kzg_fold":
            split = {"cios": fold_split(lambda: kr(name, *args)),
                     "mma": fold_split(lambda: km(name, *args))}
            log(f"[timing] kzg_fold's CUDA kernels a call, device us "
                f"(torch.profiler): " + json.dumps(
                    {e: "not measured" if v is None else
                     {k: round(t, 1) for k, t in v.items()}
                     for e, v in split.items()}))
            rows[-1]["device_split_us"] = split
        if name == "gather_hm":
            # the wrapper a caller calls, its outputs held as the mesh does
            from teku_tpu_torch.ops.kernels import shard as KSH
            held = []
            split = launch_split(lambda: held.append(KSH.gather_hm(*args)))
            lsplit = launch_split(lambda: held.append(torch.index_select(
                args[0], 0, args[1])))
            held.clear()
            fmt = (lambda v: "not measured" if v is None  # noqa: E731
                   else f"{v:.1f}")
            log(f"[timing] gather_hm a call (the wrapper), its outputs "
                f"held: host {fmt(split[0])} us, device {fmt(split[1])} "
                f"us, CUDA launches {fmt(split[2])} {split[3]}; "
                f"torch.index_select: "
                f"host {fmt(lsplit[0])} us, device {fmt(lsplit[1])} us, "
                f"launches {fmt(lsplit[2])} {lsplit[3]}")
            rows[-1].update(host_us=split[0], device_us=split[1],
                            cuda_launches_per_call=split[2],
                            library_host_us=lsplit[0],
                            library_device_us=lsplit[1],
                            regimes_us=regimes)
            if split[2] is None:
                fail("gather_hm: torch.profiler shows no device activity, "
                     "so its launches a call are not counted")
            if split[2] != 1:
                fail(f"gather_hm made {split[2]} CUDA launches a call "
                     f"(kernels, memsets and copies), expected 1")
    finish_ms = next(r["ms"] for r in rows
                     if r["name"] == "finish" and r["path"] == "ladder")
    return (rows + final_exp_rows(imad_rate, launches, finish_ms,
                                  counts["final_exp"], dev)
            + row11_rows(imad_rate, launches, dev))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--gather-regimes-of", metavar="DIR",
                    help="run only gather_regimes, with the teku_tpu_torch "
                    "package of the checkout DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    sys.path.insert(0, os.path.abspath(
        args.gather_regimes_of or os.path.dirname(os.path.abspath(__file__))))
    try:
        import teku_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the teku_tpu_torch package is not beside chip_smoke.py: {exc}")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    if args.gather_regimes_of:
        from teku_tpu_torch.ops import _build
        log(f"[gather] teku_tpu_torch of {args.gather_regimes_of}: "
            f"{len(_build.build_all())} libraries built")
        out = gather_regimes(Signer(args.seed, 256), dev)
        print(json.dumps({"gather_regimes_us": out}), flush=True)
        return
    phase_build()
    t0 = time.perf_counter()
    signer = Signer(args.seed, 256)
    log(f"[inputs] 256 seeded keys in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aggregate_args = phase_parity(signer, dev)
    log(f"[parity] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_coop(dev)
    log(f"[coop] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_row11(dev)
    log(f"[row11] parity done in {time.perf_counter() - t0:.1f} s")
    recorder = Recorder()
    for group, inputs in aggregate_args.items():
        recorder.args[(f"parity {group}", "aggregate_points")] = inputs
    launches = phase_verify(signer, dev, recorder)
    t0 = time.perf_counter()
    launches.update(phase_mesh(signer, dev, recorder))
    regimes = gather_regimes(signer, dev)
    log(f"[mesh] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_kzg(dev, args.seed, recorder))
    log(f"[kzg] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_engine_parity(recorder)
    log(f"[engines] done in {time.perf_counter() - t0:.1f} s")
    rows = phase_timing(recorder, launches, dev, regimes)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
