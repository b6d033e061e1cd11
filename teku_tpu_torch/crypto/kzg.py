"""KZG polynomial commitments (EIP-4844 blob verification), pure Python.

The port's own copy of teku_tpu/crypto/kzg.py (teku_tpu_torch imports
nothing of teku_tpu); keep the two in step.  Built on the port's copies
of the BLS12-381 oracle (crypto/bls): barycentric evaluation in the
scalar field, Pippenger MSM over the Lagrange setup, the two-pairing
proof check, the ``set_backend`` seam (ops/kzg.py:TorchKzg runs the
device path on the card) and the facade entry points.

Left out: the reference's capacity accounting of blob arrivals
(``_record_kzg_arrival``, ``kzg_verify_class``), which feeds the
infra/capacity and services/admission layers the port does not have
yet.  It swallows every error and changes no verdict.

Trusted setups load from the standard ceremony text format (4096
G1-Lagrange points, 65 G2-monomial points); the mainnet ceremony file is
vendored under teku_tpu_torch/resources.  ``insecure_setup(tau)`` builds
a dev/test setup with KNOWN tau (tests only).  ``from_reference_setup``
copies a setup object of the same fields (the reference's) into this
module's type, so one setup can feed both packages.
"""

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .bls import constants as K
from .bls import curve as C
from .bls import fields as F
from .bls import pairing as PAIR

R = K.R                                    # BLS scalar field modulus
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT
PRIMITIVE_ROOT = 7
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_DOMAIN = b"RCKZGBATCH___V1_"

G1 = C.G1_GENERATOR
G2 = C.G2_GENERATOR


class KzgError(ValueError):
    """Malformed blob/commitment/proof input."""


class BackendUnavailable(RuntimeError):
    """The accelerated backend cannot serve this dispatch (circuit
    open, deadline overrun, device fault).  The facade falls through to
    the host path: a sick device costs latency, never a verdict."""


# --------------------------------------------------------------------------
# Roots of unity (bit-reversed order, matching c-kzg's Lagrange layout)
# --------------------------------------------------------------------------

def _bit_reversed_roots() -> List[int]:
    order = FIELD_ELEMENTS_PER_BLOB
    w = pow(PRIMITIVE_ROOT, (R - 1) // order, R)
    roots = [1] * order
    for i in range(1, order):
        roots[i] = roots[i - 1] * w % R
    width = order.bit_length() - 1
    return [roots[int(format(i, f"0{width}b")[::-1], 2)]
            for i in range(order)]


_ROOTS: Optional[List[int]] = None


def roots_of_unity() -> List[int]:
    global _ROOTS
    if _ROOTS is None:
        _ROOTS = _bit_reversed_roots()
    return _ROOTS


# --------------------------------------------------------------------------
# Field / bytes helpers
# --------------------------------------------------------------------------

def bytes_to_bls_field(b: bytes) -> int:
    if len(b) != BYTES_PER_FIELD_ELEMENT:
        raise KzgError("field element must be 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= R:
        raise KzgError("field element out of range")
    return v


def blob_to_polynomial(blob: bytes) -> List[int]:
    if len(blob) != BYTES_PER_BLOB:
        raise KzgError(f"blob must be {BYTES_PER_BLOB} bytes")
    return [bytes_to_bls_field(blob[i * 32:(i + 1) * 32])
            for i in range(FIELD_ELEMENTS_PER_BLOB)]


def evaluate_polynomial_in_evaluation_form(poly: Sequence[int],
                                           z: int) -> int:
    """Barycentric: p(z) = (z^n - 1)/n * sum_i p_i * w_i / (z - w_i)."""
    n = FIELD_ELEMENTS_PER_BLOB
    roots = roots_of_unity()
    for i, w in enumerate(roots):
        if z == w:
            return poly[i] % R
    # batch-invert the (z - w_i) denominators with one Fermat pass
    denoms = [(z - w) % R for w in roots]
    invs = _batch_inverse(denoms)
    acc = 0
    for p_i, w, inv in zip(poly, roots, invs):
        acc = (acc + p_i * w % R * inv) % R
    acc = acc * (pow(z, n, R) - 1) % R
    acc = acc * pow(n, R - 2, R) % R
    return acc


# --------------------------------------------------------------------------
# Trusted setup
# --------------------------------------------------------------------------

@dataclass
class TrustedSetup:
    g1_lagrange: Optional[List[Tuple]]     # None for insecure setups
    g2_monomial: List[Tuple]               # at least [G2, [s]G2]
    g1_monomial: Optional[List[Tuple]] = None
    tau: Optional[int] = None              # ONLY for insecure dev setups

    @property
    def s_g2(self):
        return self.g2_monomial[1]


def load_trusted_setup(path) -> TrustedSetup:
    """Parse the standard ceremony text format: counts, G1-Lagrange
    points (bit-reversed), G2 monomial points, and (extended format)
    G1 monomial points (reference: TrustedSetup.java /
    CKZG4844.loadTrustedSetup)."""
    lines = Path(path).read_text().split()
    n_g1, n_g2 = int(lines[0]), int(lines[1])
    if n_g1 != FIELD_ELEMENTS_PER_BLOB:
        raise KzgError(f"expected {FIELD_ELEMENTS_PER_BLOB} G1 points")
    hexes = lines[2:]
    if len(hexes) not in (n_g1 + n_g2, 2 * n_g1 + n_g2):
        raise KzgError("trusted setup length mismatch")
    g1 = [C.g1_decompress(bytes.fromhex(h)) for h in hexes[:n_g1]]
    # the file stores Lagrange points in natural order; the library
    # works in bit-reversed order throughout (c-kzg applies the same
    # permutation in its load_trusted_setup)
    width = n_g1.bit_length() - 1
    g1 = [g1[int(format(i, f"0{width}b")[::-1], 2)] for i in range(n_g1)]
    g2 = [C.g2_decompress(bytes.fromhex(h))
          for h in hexes[n_g1:n_g1 + n_g2]]
    g1_mono = None
    if len(hexes) == 2 * n_g1 + n_g2:
        g1_mono = [C.g1_decompress(bytes.fromhex(h))
                   for h in hexes[n_g1 + n_g2:]]
        gen = C.to_affine(C.FQ_OPS, g1_mono[0])
        if gen != (K.G1_X, K.G1_Y):
            raise KzgError("monomial[0] is not the G1 generator")
    return TrustedSetup(g1_lagrange=g1, g2_monomial=g2,
                        g1_monomial=g1_mono)


def insecure_setup(tau: int = 0x107) -> TrustedSetup:
    """Dev setup with known tau — commitments become a single scalar
    multiplication.  Tests only."""
    s_g2 = C.point_mul(C.FQ2_OPS, tau, G2)
    return TrustedSetup(g1_lagrange=None,
                        g2_monomial=[G2, s_g2], tau=tau)


def _ints(v):
    return tuple(_ints(x) for x in v) if isinstance(v, (tuple, list)) \
        else int(v)


def from_reference_setup(setup) -> TrustedSetup:
    """A TrustedSetup with the points of `setup`, any object with this
    type's fields (the reference's TrustedSetup): the same Jacobian
    integer tuples, copied."""
    def pts(v):
        return None if v is None else [_ints(p) for p in v]
    return TrustedSetup(g1_lagrange=pts(setup.g1_lagrange),
                        g2_monomial=pts(setup.g2_monomial),
                        g1_monomial=pts(setup.g1_monomial),
                        tau=setup.tau)


_SETUP: Optional[TrustedSetup] = None
# the public KZG-ceremony output (the exact artifact every consensus
# client ships), the port's copy of the reference's vendored file
REFERENCE_SETUP_PATH = str(
    Path(__file__).resolve().parents[1]
    / "resources" / "mainnet-trusted-setup.txt")


def get_setup() -> TrustedSetup:
    global _SETUP
    if _SETUP is None:
        if not Path(REFERENCE_SETUP_PATH).is_file():
            # NEVER degrade to the known-tau dev setup implicitly —
            # that would make default-path proofs forgeable
            raise KzgError(
                "trusted setup missing; call set_setup() explicitly "
                f"(looked at {REFERENCE_SETUP_PATH})")
        _SETUP = load_trusted_setup(REFERENCE_SETUP_PATH)
    return _SETUP


def set_setup(setup: Optional[TrustedSetup]) -> None:
    global _SETUP
    _SETUP = setup


# --------------------------------------------------------------------------
# MSM (host Pippenger; the device path reuses ops/points batching)
# --------------------------------------------------------------------------

def g1_msm(points: Sequence[Tuple], scalars: Sequence[int],
           window: int = 8) -> Tuple:
    """Pippenger bucket MSM over G1 (the role blst's mult_pippenger
    plays for c-kzg; reference consumes it via JNI)."""
    ops = C.FQ_OPS
    acc = C.infinity(ops)
    n_windows = (255 + window - 1) // window
    for w in range(n_windows - 1, -1, -1):
        for _ in range(window):
            acc = C.point_double(ops, acc)
        buckets = [None] * (1 << window)
        shift = w * window
        mask = (1 << window) - 1
        for p, s in zip(points, scalars):
            b = (s >> shift) & mask
            if b:
                buckets[b] = p if buckets[b] is None else C.point_add(
                    ops, buckets[b], p)
        running = C.infinity(ops)
        total = C.infinity(ops)
        for b in range(len(buckets) - 1, 0, -1):
            if buckets[b] is not None:
                running = C.point_add(ops, running, buckets[b])
            total = C.point_add(ops, total, running)
        acc = C.point_add(ops, acc, total)
    return acc


# --------------------------------------------------------------------------
# Commitments and proofs
# --------------------------------------------------------------------------

def blob_to_kzg_commitment(blob: bytes,
                           setup: Optional[TrustedSetup] = None) -> bytes:
    setup = setup or get_setup()
    poly = blob_to_polynomial(blob)
    if setup.tau is not None:
        # known tau: p(tau) in the field, then ONE scalar mul
        y = evaluate_polynomial_in_evaluation_form(poly, setup.tau)
        return C.g1_compress(C.point_mul(C.FQ_OPS, y, G1))
    if _BACKEND is not None:
        try:
            # device ladder MSM over the Lagrange basis (ops/kzg.py)
            return _BACKEND.g1_lincomb(setup, poly)
        except BackendUnavailable:
            pass                 # host Pippenger serves this call
    pt = g1_msm(setup.g1_lagrange, poly)
    return C.g1_compress(pt)


def compute_kzg_proof_impl(poly: List[int], z: int,
                           setup: Optional[TrustedSetup] = None
                           ) -> Tuple[bytes, int]:
    """(proof, y): quotient witness for p(z) = y."""
    setup = setup or get_setup()
    y = evaluate_polynomial_in_evaluation_form(poly, z)
    roots = roots_of_unity()
    n = FIELD_ELEMENTS_PER_BLOB
    # quotient in evaluation form: q_i = (p_i - y) / (w_i - z)
    denoms = [(w - z) % R for w in roots]
    if any(d == 0 for d in denoms):
        # z hits a root: use the standard special-case formula
        m = denoms.index(0)
        q = [0] * n
        for i in range(n):
            if i == m:
                continue
            q[i] = (poly[i] - y) * pow(denoms[i], R - 2, R) % R
            q[m] = (q[m] - q[i] * roots[i] % R
                    * pow(roots[m], R - 2, R)) % R
        quotient = q
    else:
        invs = _batch_inverse(denoms)
        quotient = [(p - y) * inv % R for p, inv in zip(poly, invs)]
    if setup.tau is not None:
        q_tau = evaluate_polynomial_in_evaluation_form(quotient, setup.tau)
        return C.g1_compress(C.point_mul(C.FQ_OPS, q_tau, G1)), y
    if _BACKEND is not None:
        try:
            return _BACKEND.g1_lincomb(setup, quotient), y
        except BackendUnavailable:
            pass
    return C.g1_compress(g1_msm(setup.g1_lagrange, quotient)), y


def _batch_inverse(xs: List[int]) -> List[int]:
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def compute_blob_kzg_proof(blob: bytes, commitment: bytes,
                           setup: Optional[TrustedSetup] = None) -> bytes:
    poly = blob_to_polynomial(blob)
    z = compute_challenge(blob, commitment)
    proof, _ = compute_kzg_proof_impl(poly, z, setup)
    return proof


# --------------------------------------------------------------------------
# Verification
# --------------------------------------------------------------------------

def _decompress_g1_checked(b: bytes, what: str):
    try:
        p = C.g1_decompress(b)
    except Exception as exc:
        raise KzgError(f"bad {what}: {exc}") from exc
    if not C.is_infinity(C.FQ_OPS, p) and not C.g1_in_subgroup(p):
        raise KzgError(f"{what} not in subgroup")
    return p


def verify_kzg_proof_impl(commitment_pt, z: int, y: int, proof_pt,
                          setup: Optional[TrustedSetup] = None) -> bool:
    """e(C - [y]G1, G2) == e(proof, [s-z]G2), via one 2-term multi
    pairing (reference: c-kzg verify_kzg_proof)."""
    setup = setup or get_setup()
    ops1, ops2 = C.FQ_OPS, C.FQ2_OPS
    p_min_y = C.point_add(ops1, commitment_pt,
                          C.point_neg(ops1, C.point_mul(ops1, y, G1)))
    s_min_z = C.point_add(ops2, setup.s_g2,
                          C.point_neg(ops2, C.point_mul(ops2, z, G2)))
    a1 = C.to_affine(ops1, C.point_neg(ops1, p_min_y))
    a2 = C.to_affine(ops2, G2)
    b1 = C.to_affine(ops1, proof_pt)
    b2 = C.to_affine(ops2, s_min_z)
    out = PAIR.multi_pairing([(a1, a2), (b1, b2)])
    return out == F.FQ12_ONE


def _verify_blob_kzg_proof_host(blob: bytes, commitment: bytes,
                                proof: bytes,
                                setup: Optional[TrustedSetup] = None
                                ) -> bool:
    """Host-only pairing path — shared by the no-backend case and the
    BackendUnavailable fallbacks (which must NOT re-enter the device)."""
    try:
        c_pt = _decompress_g1_checked(commitment, "commitment")
        p_pt = _decompress_g1_checked(proof, "proof")
        poly = blob_to_polynomial(blob)
    except KzgError:
        return False
    z = compute_challenge(blob, commitment)
    y = evaluate_polynomial_in_evaluation_form(poly, z)
    return verify_kzg_proof_impl(c_pt, z, y, p_pt, setup)


def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes,
                          setup: Optional[TrustedSetup] = None) -> bool:
    """reference KZG.verifyBlobKzgProof (CKZG4844.java:104-113)."""
    if _BACKEND is not None and len(blob) == BYTES_PER_BLOB:
        try:
            return _BACKEND.verify_blob_kzg_proof(
                blob, commitment, proof, setup or get_setup())
        except KzgError:
            return False
        except BackendUnavailable:
            pass                 # host pairing path serves this call
    return _verify_blob_kzg_proof_host(blob, commitment, proof, setup)


# Pluggable accelerated backend (the KZG analogue of the BLS facade's
# set_implementation seam): installed by the loader alongside the JAX
# BLS provider, mirroring the reference's initKzg wiring
# (BeaconChainController.java:557-572 -> CKZG4844 JNI singleton).
_BACKEND = None


def set_backend(backend) -> None:
    global _BACKEND
    _BACKEND = backend


def get_backend():
    return _BACKEND


def backend_name() -> str:
    return getattr(_BACKEND, "name", "host-pure") if _BACKEND else \
        "host-pure"


def verify_blob_kzg_proof_batch(blobs: Sequence[bytes],
                                commitments: Sequence[bytes],
                                proofs: Sequence[bytes],
                                setup: Optional[TrustedSetup] = None
                                ) -> bool:
    """reference KZG.verifyBlobKzgProofBatch (CKZG4844.java:115-122):
    one random-linear-combination fold -> 2 pairings for the whole
    batch, dispatched to the device backend when installed."""
    if not (len(blobs) == len(commitments) == len(proofs)):
        return False
    if not blobs:
        return True
    if _BACKEND is not None:
        try:
            return _BACKEND.verify_blob_kzg_proof_batch(
                blobs, commitments, proofs, setup or get_setup())
        except KzgError:
            return False
        except BackendUnavailable:
            # the device just failed this batch: serve it entirely
            # from the host path rather than paying a fresh device
            # deadline per blob on a backend we know is sick
            return _verify_batch_host(blobs, commitments, proofs,
                                      setup)
    # no backend installed: the host path directly — per-blob re-entry
    # through verify_blob_kzg_proof would double-count the demand
    return _verify_batch_host(blobs, commitments, proofs, setup)


def _verify_batch_host(blobs, commitments, proofs, setup) -> bool:
    """Per-blob host verification with an explicit first-failure exit:
    once one blob fails the batch verdict is False, and each remaining
    blob would cost a 4096-point barycentric pass + a 2-pairing check
    on a host that is already degraded."""
    for b, c, p in zip(blobs, commitments, proofs):
        if not _verify_blob_kzg_proof_host(b, c, p, setup):
            return False
    return True


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    """Fiat-Shamir challenge: sha256(domain || uint128_be(degree) ||
    blob || commitment) reduced mod r (EIP-4844 compute_challenge)."""
    data = (FIAT_SHAMIR_PROTOCOL_DOMAIN
            + FIELD_ELEMENTS_PER_BLOB.to_bytes(16, "big")
            + blob + commitment)
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R
