// GRU sequence over precomputed input projections, for Hopper (sm_90a): one or
// both directions of a bidirectional GRU in one launch.
//
// Replaces the TPU kernel `_gru_seq_kernel` / `gru_sequence` of
// ocrs_tpu/ops/gru_pallas.py. Per step t (zero initial state):
//   hp = h . wh                                  [rows, 3H], f32
//   r  = sigmoid(xr[t] + hr + br)
//   z  = sigmoid(xz[t] + hz + bz)
//   n  = tanh(xn[t] + r * (hn + bn))             (bn inside the r term)
//   h  = (1 - z) * n + z * h ;  out[t] = h
// A reverse direction walks t from T-1 down to 0 without flipping data; its
// outputs land in original time order.
//
// What bounds it: the recurrence. Counted as work, the f32 operations bound it
// (2*N*H*3H*T; the bytes are fewer), but the T steps depend on one another, so
// the real limit is the latency of one step, T times. The TPU kernel keeps wh
// and h in fast memory for the whole sequence. wh in f32 is 442 KB at H = 192,
// more than the 227 KB of shared memory of one block, but not more than a
// thread-block cluster holds.
//
// Design:
//  * One cluster of C <= 8 blocks (16 above hidden 256, see below) per (direction,
//    row tile of at most 16 rows).
//    Block c of the cluster owns U hidden units i in [c*U, c*U + U) and the
//    three gate columns i, H+i, 2H+i of wh for them: an [H, 3U] slice (55 KB at
//    H = 192, U = 24), loaded into shared memory once and kept for all T steps.
//    Splitting by hidden unit keeps the gate math local: a block has hr, hz, hn
//    of its own units and needs nothing of its peers but h.
//  * Every block keeps the full h of its rows in shared memory, twice, laid
//    out [owner block][row][unit] so that the units a block owns are one
//    contiguous piece. After the gates of step s a block writes its piece of
//    buffer (s+1)&1 and copies it into the same place of every peer through
//    distributed shared memory: one bulk copy per peer
//    (cp.async.bulk.shared::cluster), which counts its bytes on an mbarrier of
//    the receiver. A block starts step s+1 when the mbarrier of that buffer has
//    seen all peers' bytes: it waits for data, not for a barrier of the whole
//    cluster. Two buffers are enough: a peer can send the h of step s+1 only
//    after it has received every block's h of step s, so after every thread
//    here has finished reading the buffer that the send overwrites.
//  * The product runs on the tensor cores at f32 accuracy: mma.sync m16n8k8 in
//    TF32 with both operands split into a high and a low TF32 part, three
//    products per tile (lo*hi + hi*lo + hi*hi, "3xTF32"), f32 accumulation.
//    With f32 FMAs the same product is bound by shared-memory reads (every FMA
//    wants two operands, and a load delivers one word per lane and pass); a
//    tensor core tile uses each loaded word 8 or 16 times. The rows of the tile
//    are the M = 16 of the instruction, 8 units of a gate its N = 8. The 8
//    warps split k; each writes its partial sums to shared memory, and after
//    one __syncthreads() the gate threads, one per (row, unit), add the 8
//    partials and go on to sigmoid/tanh and the h update: no hp in global
//    memory, no second kernel. wh's slice is stored in the order of the
//    instruction's B fragments, so that a warp reads it without bank conflicts.
//  * sigmoid and tanh use the fast exponential and division (__expf,
//    __fdividef). Against the plain version the result moves by about 1e-6 at
//    T = 608, which the 1e-4 tolerance covers.
//  * out[t] and the next step's xr/xz/xn are written and fetched after the
//    sends, while the peers' data is on its way.
//  * Inputs and output are addressed by element strides for (t, n), so the
//    kernel reads the projection where the matrix product left it and writes
//    both directions into the halves of one tensor.
//  * Hidden sizes above 256 (up to 512) take a non-portable cluster of up to
//    16 blocks of at most 32 units each (Hopper schedules a cluster of 16 on
//    one GPC with cudaFuncAttributeNonPortableClusterSizeAllowed). The eight
//    warps then take two or more k steps of 8 each per unit tile. Where the
//    [H, 3U] slice of wh does not fit beside h and the partial sums (at
//    U = 32: 196 KB, H > 384), the block reads its B fragments straight from
//    wh in global memory every step instead (WG): a warp's load is four rows
//    of 8 neighbouring floats, whole 32-byte sectors, and the whole of wh
//    (3 MB at H = 512) stays in the 50 MB L2 for all T steps.
//
// MODE 1 and 2 are timing-only variants of the same kernel: 1 leaves out the
// recurrent product (the sum of partials, gates, global traffic and exchange
// remain), 2 leaves out everything but the exchange of h and the wait for it.
// They measure what the dependent chain costs without arithmetic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;  // k parts of the product
constexpr int kRows = 16;              // rows of a tile: M of the mma
constexpr int kMaxOut = 2;             // (row, unit) outputs per thread in the gate phase:
                                       // kRows * 32 units at most

struct Dir {
  const float* xr;
  const float* xz;
  const float* xn;
  const float* wh;  // [H, 3H] row-major
  const float* bh;  // [3H]
  float* out;
  long long xs_t, xs_n;  // element strides of xr/xz/xn for t and n (inner stride 1)
  long long os_t, os_n;  // element strides of out
  int reverse;
};

struct Args {
  Dir d[2];
  int T, N, H;
  int U;        // hidden units per block
  int R;        // rows per tile (<= kRows)
  int n_tiles;  // row tiles per direction
};

__device__ __forceinline__ float sigmoid_f32(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_f32(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The address of this block's shared-memory address `addr` in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_to_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned mbar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mbar), "r"(count) : "memory");
}
// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  } while (!done);
}
// Copy `bytes` (a multiple of 16, 16-byte aligned) of this block's shared memory
// into a peer's, counted on the peer's mbarrier.
__device__ __forceinline__ void bulk_copy_to_peer(unsigned peer_dst, unsigned src, unsigned bytes,
                                                  unsigned peer_mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(peer_dst),
      "r"(src), "r"(bytes), "r"(peer_mbar)
      : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 bits of mantissa, ties away from
// zero), lo the exact rest, of which the tensor core reads the leading TF32
// bits. The two parts of the 3xTF32 product. Integer and float ALU operations
// only: cvt.rna.tf32.f32 does the same rounding at a sixteenth of their rate.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// acc[16x8] += a[16x8] * b[8x8], TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float* acc, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// With -DOCRS_GRU_PROFILE thread 0 of block 0 adds up the clocks it spends in
// each phase of a step: PROF(i) closes phase i. ocrs_gru_seq_profile reads the
// sums (tools/torch_gru_profile.py prints them).
#ifdef OCRS_GRU_PROFILE
__device__ long long g_prof[8];
#define PROF(i)                                               \
  do {                                                        \
    const long long now_ = clock64();                         \
    if (tid == 0 && blockIdx.x == 0) g_prof[i] += now_ - tprev; \
    tprev = now_;                                             \
  } while (0)
#else
#define PROF(i)
#endif

// k runs over a padded index space: block b's units sit at k in [b*UH, b*UH + U)
// with UH = U rounded up to 8, so that a k step of the mma (8 wide) lies in one
// block's piece of h; wh has zero rows and h stays zero at the pad positions.
//
// Shared memory, in this order (ocrs_tpu_torch/ops/gru.py::launch_plan sizes it):
//   mbar 2 x 8 bytes (16)               one mbarrier per h buffer
//   ws   float2 [K8][3][UT][32]         wh slice as B fragments: k step, gate, tile
//                                       of 8 units, lane; K8 = C*UH/8, UT = UH/8
//                                       (left out under WG)
//   hs   float  [2][C][kRows][RS]       h, two buffers; RS = UH + 4 (no bank conflicts)
//   part float  [kWarps][3][kRows][UH]  partial sums per k part
//   bs   float  [3][U]                  bh of the block's units
// B fragment (k step ks, gate g, unit tile ut) of this lane, read from wh in
// global memory (WG): rows of wh at padded k = ks*8 + lane%4 and + 4, column of
// unit ut*8 + lane/4; zero at the pad positions, as the packed slice holds it.
template <int UT>
__device__ __forceinline__ float2 b_fragment_global(const float* wh, int H, int U, int u0, int ucnt,
                                                    int ks, int g, int ut, int lane) {
  const int kb = ks / UT;                          // block whose piece of h this k step reads
  const int ku = (ks - kb * UT) * 8 + (lane & 3);  // unit in that block, first of the two rows
  const int u = ut * 8 + (lane >> 2);
  const int k = kb * U + ku;  // row of wh
  const float* col = wh + g * H + u0 + u;
  const bool ok = u < ucnt;
  const float w0 = (ok && ku < U && k < H) ? __ldg(col + static_cast<size_t>(k) * 3 * H) : 0.0f;
  const float w1 =
      (ok && ku + 4 < U && k + 4 < H) ? __ldg(col + static_cast<size_t>(k + 4) * 3 * H) : 0.0f;
  return make_float2(w0, w1);
}

// UT: tiles of 8 units per block; KSM: the most k steps a warp takes,
// ceil(C * UT / 8) (UT for clusters of up to 8, 2*UT for up to 16); WG: wh is
// read from global memory each step instead of a slice in shared memory.
template <int MODE, int UT, int KSM, bool WG>
__global__ void __launch_bounds__(kThreads) gru_seq_cluster_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C;
  const Dir& d = a.d[cid / a.n_tiles];
  const int row0 = (cid % a.n_tiles) * a.R;
  const int rows = min(a.R, a.N - row0);
  const int H = a.H, U = a.U;
  constexpr int UH = UT * 8;  // U rounded up to 8
  const int K8 = C * UT;
  constexpr int RS = UH + 4;
  const int KS = (K8 + kWarps - 1) / kWarps;  // k steps per warp, at most UT
  const int u0 = c * U;
  const int ucnt = min(U, H - u0);
  const int tid = threadIdx.x;
  const int piece = kRows * RS;  // floats of one block's piece of h
  const int hbuf = C * piece;    // floats of one h buffer
  const int pgate = kRows * UH;  // floats of one gate of one k part
  const int ppart = 3 * pgate;   // floats of one k part

  const unsigned mbar0 = smem_u32(smem4);
  float2* ws = reinterpret_cast<float2*>(smem4 + 1);
  float* hs = reinterpret_cast<float*>(WG ? ws : ws + K8 * 3 * UT * 32);
  float* part = hs + 2 * hbuf;
  float* bs = part + kWarps * ppart;

  for (int i = tid; i < 2 * hbuf + kWarps * ppart; i += kThreads) hs[i] = 0.0f;  // hs and part
  for (int i = tid; i < 3 * U; i += kThreads) {
    const int g = i / U, u = i - g * U;
    bs[i] = u < ucnt ? d.bh[g * H + u0 + u] : 0.0f;
  }
  if (MODE == 0 && !WG) {
    // B fragment of (k step ks, gate g, unit tile ut), lane l: rows of wh at
    // padded k = ks*8 + l%4 and + 4, column of unit ut*8 + l/4.
    for (int i = tid; i < K8 * 3 * UT * 32; i += kThreads) {
      const int l = i % 32;
      const int ut = (i / 32) % UT;
      const int g = (i / (32 * UT)) % 3;
      const int ks = i / (32 * UT * 3);
      const int u = ut * 8 + l / 4;
      float w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = ks * 8 + (l % 4) + 4 * j;  // padded k
        const int kb = kk / UH, ku = kk - kb * UH;
        const int k = kb * U + ku;  // row of wh
        w[j] = (ku < U && k < H && u < ucnt)
                   ? d.wh[static_cast<size_t>(k) * 3 * H + g * H + u0 + u]
                   : 0.0f;
      }
      ws[i] = make_float2(w[0], w[1]);
    }
  }
  // Each step every peer sends its piece of the valid rows.
  const unsigned piece_bytes = static_cast<unsigned>(rows) * RS * 4u;
  const unsigned fill_bytes = piece_bytes * (C - 1);
  if (tid == 0) {
    mbar_init(mbar0, 1);
    mbar_init(mbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (C > 1 && a.T > 1) mbar_expect(mbar0 + 8, fill_bytes);  // filled by step 0
    if (C > 1 && a.T > 2) mbar_expect(mbar0, fill_bytes);      // filled by step 1
  }
  // No block may write a peer's h before that peer has zeroed it.
  cluster.sync();

  // Product phase: this warp's k steps, this lane's place in the fragments.
  const int warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // the mma's groupID and threadID_in_group
  const int ks_lo = warp * KS;
  const int ks_hi = min(K8, ks_lo + KS);

  // Gate phase: output o of this thread is (row, unit) number tid + o*kThreads.
  bool valid[kMaxOut];
  int hoff[kMaxOut], poff[kMaxOut];
  size_t xoff[kMaxOut], ooff[kMaxOut];
  float br[kMaxOut], bz[kMaxOut], bn[kMaxOut];
  float xr[kMaxOut], xz[kMaxOut], xn[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const int idx = tid + o * kThreads;
    const int i = idx / U, u = idx - i * U;
    valid[o] = i < rows && u < ucnt;
    hoff[o] = valid[o] ? c * piece + i * RS + u : 0;
    poff[o] = valid[o] ? i * UH + u : 0;
    xoff[o] = static_cast<size_t>(row0 + i) * d.xs_n + u0 + u;
    ooff[o] = static_cast<size_t>(row0 + i) * d.os_n + u0 + u;
    br[o] = valid[o] ? bs[u] : 0.0f;
    bz[o] = valid[o] ? bs[U + u] : 0.0f;
    bn[o] = valid[o] ? bs[2 * U + u] : 0.0f;
    xr[o] = xz[o] = xn[o] = 0.0f;
    if (MODE != 2 && valid[o]) {
      const size_t x0 = (d.reverse ? a.T - 1 : 0) * d.xs_t + xoff[o];
      xr[o] = d.xr[x0];
      xz[o] = d.xz[x0];
      xn[o] = d.xn[x0];
    }
  }

#ifdef OCRS_GRU_PROFILE
  long long tprev = clock64();
#endif
  for (int s = 0; s < a.T; ++s) {
    const size_t t = d.reverse ? a.T - 1 - s : s;
    const float* hc = hs + (s & 1) * hbuf;
    float* hnext = hs + ((s + 1) & 1) * hbuf;
    if (s > 0 && C > 1) {
      // Buffer s&1 is complete when all peers' copies of step s-1 have landed.
      mbar_wait(mbar0 + 8 * (s & 1), ((s - 1) >> 1) & 1);
      // It is filled again by step s+1.
      if (tid == 0 && s + 2 < a.T) mbar_expect(mbar0 + 8 * (s & 1), fill_bytes);
    }
    PROF(0);  // wait for h

    if (MODE == 0) {
      // Two accumulators per (unit tile, gate): the two small products of the
      // split and the large one. The mmas are issued product by product over
      // all tiles, so that none waits for the one issued just before it.
      float acc[UT][3][2][4];
#pragma unroll
      for (int ut = 0; ut < UT; ++ut)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[ut][g][0][j] = acc[ut][g][1][j] = 0.0f;
#pragma unroll
      for (int i = 0; i < KSM; ++i) {  // KS <= KSM k steps
        const int ks = ks_lo + i;
        if (ks < ks_hi) {
          // A fragment: h of rows fg and fg + 8 at k = ks*8 + ft and + 4.
          const float* hk = hc + (ks / UT) * piece + fg * RS + (ks % UT) * 8 + ft;
          unsigned ahi[4], alo[4];
          split_tf32(hk[0], ahi[0], alo[0]);
          split_tf32(hk[8 * RS], ahi[1], alo[1]);
          split_tf32(hk[4], ahi[2], alo[2]);
          split_tf32(hk[8 * RS + 4], ahi[3], alo[3]);
          unsigned bhi[UT][3][2], blo[UT][3][2];
#pragma unroll
          for (int ut = 0; ut < UT; ++ut)
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const float2 w =
                  WG ? b_fragment_global<UT>(d.wh, H, U, u0, ucnt, ks, g, ut, lane)
                     : ws[((ks * 3 + g) * UT + ut) * 32 + lane];
              split_tf32(w.x, bhi[ut][g][0], blo[ut][g][0]);
              split_tf32(w.y, bhi[ut][g][1], blo[ut][g][1]);
            }
#pragma unroll
          for (int ut = 0; ut < UT; ++ut)
#pragma unroll
            for (int g = 0; g < 3; ++g) mma_tf32(acc[ut][g][0], alo, bhi[ut][g]);
#pragma unroll
          for (int ut = 0; ut < UT; ++ut)
#pragma unroll
            for (int g = 0; g < 3; ++g) mma_tf32(acc[ut][g][1], ahi, bhi[ut][g]);
#pragma unroll
          for (int ut = 0; ut < UT; ++ut)
#pragma unroll
            for (int g = 0; g < 3; ++g) mma_tf32(acc[ut][g][0], ahi, blo[ut][g]);
        }
      }
      // C fragments: rows fg and fg + 8, units ut*8 + 2*ft and + 1.
      float* pp = part + warp * ppart + fg * UH + 2 * ft;
#pragma unroll
      for (int ut = 0; ut < UT; ++ut)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float* lo = acc[ut][g][0];
          const float* hi = acc[ut][g][1];
          float* q = pp + g * pgate + ut * 8;
          *reinterpret_cast<float2*>(q) = make_float2(lo[0] + hi[0], lo[1] + hi[1]);
          *reinterpret_cast<float2*>(q + 8 * UH) = make_float2(lo[2] + hi[2], lo[3] + hi[3]);
        }
      PROF(1);  // product and partial sums
      __syncthreads();
      PROF(2);  // block barrier
    }

    const bool more = s + 1 < a.T;
    float hnew[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (!valid[o]) continue;
      if (MODE == 2) {
        hnew[o] = 0.5f * hc[hoff[o]] + 0.25f;
      } else {
        float sr = 0.0f, sz = 0.0f, sn = 0.0f;
        const float* pp = part + poff[o];
#pragma unroll
        for (int p = 0; p < kWarps; ++p, pp += ppart) {
          sr += pp[0];
          sz += pp[pgate];
          sn += pp[2 * pgate];
        }
        const float rgate = sigmoid_f32(xr[o] + sr + br[o]);
        const float zgate = sigmoid_f32(xz[o] + sz + bz[o]);
        const float ngate = tanh_f32(xn[o] + rgate * (sn + bn[o]));
        hnew[o] = (1.0f - zgate) * ngate + zgate * hc[hoff[o]];
      }
      // No write after the last step, so that no block is written to after it has left.
      if (more) hnext[hoff[o]] = hnew[o];
    }
    PROF(3);  // sum of partials, gates, h into this block's piece
    if (more) {
      // This block's piece of the next buffer: visible to the copy engine (the
      // async proxy), complete, then one copy into the same place of every peer.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      PROF(4);  // proxy fence
      __syncthreads();
      // Warp w sends to peers w, w + 8: the copies are issued side by side.
      if (lane == 0) {
        const unsigned src = smem_u32(hnext + c * piece);
        for (int p = warp; p < C; p += kWarps) {
          if (p == c) continue;
          bulk_copy_to_peer(map_to_rank(src, p), src, piece_bytes,
                            map_to_rank(mbar0 + 8 * ((s + 1) & 1), p));
        }
      }
    }
    PROF(5);  // block barrier and copies to the peers
    if (MODE != 2) {
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (!valid[o]) continue;
        d.out[t * d.os_t + ooff[o]] = hnew[o];
        if (more) {
          const size_t x0 = (d.reverse ? t - 1 : t + 1) * d.xs_t + xoff[o];
          xr[o] = d.xr[x0];
          xz[o] = d.xz[x0];
          xn[o] = d.xn[x0];
        }
      }
    }
    PROF(6);  // out[t] and the next step's x
  }
  // No block leaves while a peer may still read or write its shared memory.
  cluster.sync();
}

template <int MODE, int UT, int KSM, bool WG>
cudaError_t launch(const Args& a, int n_dirs, int C, int smem, cudaStream_t stream) {
  auto kernel = gru_seq_cluster_kernel<MODE, UT, KSM, WG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C * n_dirs * a.n_tiles), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The variants launch_plan gives: clusters of up to 8 with the wh slice in
// shared memory (hidden <= 256); clusters of up to 16 with the slice in shared
// memory at 3 unit tiles (hidden <= 384), and with wh read from global memory
// at 4 (hidden <= 512).
template <int MODE>
cudaError_t launch_ut(const Args& a, int n_dirs, int C, int smem, int wh_global,
                      cudaStream_t stream) {
  const int ut = (a.U + 7) / 8;  // tiles of 8 units per block
  if (C <= 8 && !wh_global) {
    switch (ut) {
      case 1: return launch<MODE, 1, 1, false>(a, n_dirs, C, smem, stream);
      case 2: return launch<MODE, 2, 2, false>(a, n_dirs, C, smem, stream);
      case 3: return launch<MODE, 3, 3, false>(a, n_dirs, C, smem, stream);
      case 4: return launch<MODE, 4, 4, false>(a, n_dirs, C, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (C > 8 && ut == 3 && !wh_global) return launch<MODE, 3, 6, false>(a, n_dirs, C, smem, stream);
  if (C > 8 && ut == 4 && wh_global) return launch<MODE, 4, 8, true>(a, n_dirs, C, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the GRU sequence kernel for `n_dirs` (1 or 2) directions on `stream`.
//
// dirs: 11 values per direction: the device addresses of xr, xz, xn (element
//   (t, n, i) of each at t*xs_t + n*xs_n + i), wh [H, 3H] row-major, bh [3H]
//   and out (element (t, n, i) at t*os_t + n*os_n + i), then xs_t, xs_n, os_t,
//   os_n in elements, then reverse (0 or 1). All tensors are f32.
// plan: C (blocks per cluster), U (hidden units per block; C*U >= H > (C-1)*U),
//   R (rows per tile, at most 16; U at most 32) and the dynamic shared memory in bytes, as
//   ocrs_tpu_torch/ops/gru.py::launch_plan computes them; C above 8 is a non-portable
//   cluster (hidden sizes above 256).
// wh_global: 1 reads wh from global memory each step (no slice in shared memory; the
//   plan's smem then leaves it out), 0 keeps the slice in shared memory.
// mode: 0 the GRU; 1 and 2 the timing-only variants (see the note on top).
// Returns 0, or the CUDA error of the refused launch.
extern "C" int ocrs_gru_seq_launch(const long long* dirs, int n_dirs, int T, int N, int H, int C,
                                   int U, int R, int smem, int wh_global, int mode, void* stream) {
  if (n_dirs < 1 || n_dirs > 2 || T <= 0 || N <= 0 || H <= 0 || C < 1 || C > 16 || U < 1 || R < 1 ||
      R > kRows || C * U < H || (C - 1) * U >= H || R * U > kMaxOut * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  for (int i = 0; i < n_dirs; ++i) {
    const long long* p = dirs + 11 * i;
    Dir& d = a.d[i];
    d.xr = reinterpret_cast<const float*>(p[0]);
    d.xz = reinterpret_cast<const float*>(p[1]);
    d.xn = reinterpret_cast<const float*>(p[2]);
    d.wh = reinterpret_cast<const float*>(p[3]);
    d.bh = reinterpret_cast<const float*>(p[4]);
    d.out = reinterpret_cast<float*>(p[5]);
    d.xs_t = p[6];
    d.xs_n = p[7];
    d.os_t = p[8];
    d.os_n = p[9];
    d.reverse = static_cast<int>(p[10]);
  }
  a.T = T;
  a.N = N;
  a.H = H;
  a.U = U;
  a.R = R;
  a.n_tiles = (N + R - 1) / R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case 0: e = launch_ut<0>(a, n_dirs, C, smem, wh_global, st); break;
    case 1: e = launch_ut<1>(a, n_dirs, C, smem, wh_global, st); break;
    case 2: e = launch_ut<2>(a, n_dirs, C, smem, wh_global, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

#ifdef OCRS_GRU_PROFILE
// Copies the 8 phase sums to `out` (host memory), or sets them to 0 if `reset`.
extern "C" int ocrs_gru_seq_profile(long long* out, int reset) {
  const long long zero[8] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(zero)));
}
#endif
