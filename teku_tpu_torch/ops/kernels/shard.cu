// shard.cu -- the kernels of the mesh dispatch (parallel/__init__.py).
//
// gather_hm replaces stage_gather_hm (teku_tpu/ops/verify.py:191): one
// thread per output row copies the 48 words of the affine G2 point
// hm[idx[r]].  The index is checked, not clamped: one outside [0, n_src)
// writes a zero row and clears ok[0].
//
// lane_affine replaces stage_lane_affine (verify.py:209): one thread per
// lane, Jacobian -> affine G1 with its own Fermat inverse, as group_row
// in scalars_group.cu does.  Affine values are unique, so the per-thread
// inverse gives the words of the reference's batched one; infinity
// (z = 0) gives (0, 0), as its inv_many maps 0 to 0.
//
// shard_partials replaces the per-shard reductions of the mesh programs
// (verify_kernel_sharded_grouped :399, verify_kernel_sharded :476): the
// Fq12 product of a shard's Miller rows and the G2 sum of its weighted
// signatures, by the halving passes of pairing.cuh in point_batch_sum's
// order, so the Jacobian sum equals the plain version's words.  An
// all-padding shard gives ONE and infinity, the identity.
//
// aggregate_points replaces aggregate_points_kernel (verify.py:528):
// affine G1 or G2 points -> Jacobian, infinity where absent, then the
// same halving sum.
//
// Bound: gather_hm moves bytes; the others 32-bit multiply-adds (one
// Fermat inverse per lane; one Fq12 product or point add per pair).

#include "pairing.cuh"

DEVNI void gather_row(long r, const int32_t* hm, const int32_t* idx, long n_src, int32_t* out,
                      uint8_t* ok) {
    long j = idx[r];
    bool in = j >= 0 && j < n_src;
    if (!LIVE) return;
    for (int w = 0; w < 48; w++) out[48 * r + w] = in ? hm[48 * j + w] : 0;
    if (!in) ok[0] = 0;
}

DEVNI void lane_affine_one(long i, const int32_t* pk_r, int32_t* out) {
    fp x, y;
    g1_to_affine(g1_load(pk_r + 36 * i), &x, &y);
    fp_store(out + 24 * i, x);
    fp_store(out + 24 * i + 12, y);
}

DEVNI void g1_sum_pass(long i, int32_t* x, long half) {
    g1_store(x + 36 * i, pt_add(g1_load(x + 36 * i), g1_load(x + 36 * (i + half))));
}

DEVNI void g1_from_affine(long i, const int32_t* pts, const uint8_t* present, int32_t* jac) {
    g1p p = pt_infinity<fp>();
    bool use = present[i] != 0;
    WHEN(use) {
        g1p q;
        q.x = fp_load(pts + 24 * i);
        q.y = fp_load(pts + 24 * i + 12);
        q.z = K_ONE;
        if (use) p = q;
    }
    g1_store(jac + 36 * i, p);
}

DEVNI void g2_from_affine(long i, const int32_t* pts, const uint8_t* present, int32_t* jac) {
    g2p p = pt_infinity<fq2>();
    bool use = present[i] != 0;
    WHEN(use) {
        g2p q;
        q.x = fq2_load(pts + 48 * i);
        q.y = fq2_load(pts + 48 * i + 24);
        q.z = fq2_one();
        if (use) p = q;
    }
    g2_store(jac + 72 * i, p);
}

#ifdef __CUDACC__
__global__ void gather_row_kernel(long n, const int32_t* hm, const int32_t* idx, long n_src,
                                  int32_t* out, uint8_t* ok) {
    SHELL(n, gather_row(ix, hm, idx, n_src, out, ok));
}

__global__ void lane_affine_one_kernel(long n, const int32_t* pk_r, int32_t* out) {
    SHELL(n, lane_affine_one(ix, pk_r, out));
}

__global__ void g1_sum_pass_kernel(long n, int32_t* x, long half) {
    SHELL(n, g1_sum_pass(ix, x, half));
}

__global__ void g1_from_affine_kernel(long n, const int32_t* pts, const uint8_t* present,
                                      int32_t* jac) {
    SHELL(n, g1_from_affine(ix, pts, present, jac));
}

__global__ void g2_from_affine_kernel(long n, const int32_t* pts, const uint8_t* present,
                                      int32_t* jac) {
    SHELL(n, g2_from_affine(ix, pts, present, jac));
}
#endif

// out (rows, 48); ok[0] must be 1 on entry
extern "C" int gather_hm(const int32_t* hm, long n_src, const int32_t* idx, int32_t* out,
                         uint8_t* ok, long rows, void* stream) {
    LAUNCH(rows, gather_row, hm, idx, n_src, out, ok);
    return 0;
}

extern "C" int lane_affine(const int32_t* pk_r, int32_t* out, long n, void* stream) {
    LAUNCH(n, lane_affine_one, pk_r, out);
    return 0;
}

// ml (rows, 144) and wsig (lanes, 72) are reduced in place into row 0
extern "C" int shard_partials(int32_t* ml, long rows, int32_t* wsig, long lanes, void* stream) {
    HALVING(rows, fq12_prod_pass, ml, 144);
    HALVING(lanes, g2_sum_pass, wsig, 72);
    return 0;
}

// pts (n, 2, 12) (g2 = 0) or (n, 2, 2, 12) (g2 = 1) -> the Jacobian sum in
// jac's row 0 (jac holds n Jacobian points of scratch)
extern "C" int aggregate_points(const int32_t* pts, const uint8_t* present, int g2, int32_t* jac,
                                long n, void* stream) {
    if (g2) {
        LAUNCH(n, g2_from_affine, pts, present, jac);
        HALVING(n, g2_sum_pass, jac, 72);
    } else {
        LAUNCH(n, g1_from_affine, pts, present, jac);
        HALVING(n, g1_sum_pass, jac, 36);
    }
    return 0;
}
