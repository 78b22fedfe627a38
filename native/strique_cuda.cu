// CUDA kernels of the device hot path, called from JAX through the XLA FFI
// (strique_tpu/ops/cuda.py builds and registers them).
//
//   strique_wave_fwd   flank DP forward: anti-diagonal wavefront, one thread
//                      block per (read, template) row, DP state in registers,
//                      4-bit pointer codes packed 8 diagonal steps per int32
//                      word in the layout of ops.align.align_diag.
//   strique_traceback  one thread per row walks that pointer plane
//                      (ops.align.traceback_pointers, packed="diag").
//   strique_viterbi    factored max-plus Viterbi forward plus the
//                      recompute-backward, one block per read, one thread
//                      per HMM state (ops.viterbi.viterbi_scan_factored).
//
// Build with --fmad=false: every product and sum then rounds on its own, as
// XLA's separate multiply and add do, so the float32 value streams match the
// plain lax references.
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerThread = 4;  // template rows striped over each thread
constexpr int kMaxRolls = 32;
constexpr int kMaxChains = 4;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// Flank DP forward
// ---------------------------------------------------------------------------
// Step t computes every cell (i, j) with i + j - 1 == t.  Thread `tid` owns
// rows i0 .. i0+K-1 (i0 = K*tid).  A cell needs S(i-1, j-1) from diagonal t-2,
// S(i, j-1) and Ih(i, j-1) from diagonal t-1 (own row), and the running column
// max C(i-1, j) from diagonal t-1.  Row i0-1 belongs to the left neighbour: it
// arrives by __shfl_up_sync inside a warp and through shared memory across
// warps (double-buffered, so one __syncthreads per step suffices).
__global__ void __launch_bounds__(512) wave_fwd_kernel(
    const float* __restrict__ sig, const float* __restrict__ tmpl,
    const int32_t* __restrict__ nact, const int32_t* __restrict__ mrow,
    int n_sig, int mp, int n_rows, float off, float dmin, float go_h, float ge_h,
    float go_v, float ge_v, int32_t* __restrict__ ptr, float* __restrict__ score_out,
    int32_t* __restrict__ jend_out) {
  constexpr int K = kRowsPerThread;
  __shared__ float edge_s[2][32];
  __shared__ float edge_c[2][32];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = tid * K;
  const float g = fmaxf(ge_v, go_v);
  const int n = nact[r];
  const int m = mrow[r];
  const float* a = sig + (size_t)r * n_sig;
  const size_t word_stride = (size_t)n_rows * mp;  // int32 words per 8-step group
  int32_t* prow = ptr + (size_t)r * mp + i0;

  float T[K], fi[K], col0[K], S1[K], S2[K], Ih[K], C[K], A[K];
  uint32_t acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    T[k] = tmpl[(size_t)r * mp + i];
    fi[k] = (float)i;
    col0[k] = (i == 0) ? 0.0f : go_v + ge_v * (fi[k] - 1.0f);
    S1[k] = (i == 0) ? 0.0f : kNeg;  // diagonal -1: only cell (0, 0) is real
    S2[k] = kNeg;
    Ih[k] = kNeg;
    C[k] = kNeg;
    A[k] = a[clampi(-i, 0, n_sig - 1)];
    acc[k] = 0u;
  }
  // left neighbour's last row: S at t-2, S at t-1, C at t-1
  float left_s2 = kNeg, left_s1 = kNeg, left_c = kNeg;
  // leftmost best bottom-row cell, virtual column 0 first
  float best = go_v + ge_v * ((float)m - 1.0f);
  int best_j = 0;
  const int km = m - i0;  // this thread's slot of row m, if in [0, K)
  const int steps = n + m;  // diagonals 0 .. n+m-1 hold every reachable cell

  for (int t = 0; t < steps; ++t) {
    float An[K], nS[K], nIh[K], nC[K];
#pragma unroll
    for (int k = 0; k < K; ++k) An[k] = __ldg(a + clampi(t + 1 - (i0 + k), 0, n_sig - 1));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s_diag = k ? S2[k - 1] : left_s2;  // S(i-1, j-1)
      const float c_up = k ? C[k - 1] : left_c;      // C(i-1, j)
      const float diff = fabsf(A[k] - T[k]);
      const float sc = fmaxf(off - powf(diff, 1.2f), dmin);
      const float ih_ext = Ih[k] + ge_h;
      const float ih_open = S1[k] + go_h;
      float new_ih = fmaxf(ih_ext, ih_open);
      const float new_m = s_diag + sc;
      const float q = (i0 + k == 0) ? 0.0f : fmaxf(new_m, new_ih);
      const float cvec = q + go_v - (fi[k] + 1.0f) * g;
      nC[k] = fmaxf(c_up, cvec);
      const float new_iv = c_up + fi[k] * g;
      float new_s = fmaxf(q, new_iv);
      const uint32_t which = new_m >= new_s ? 0u : (new_iv >= new_s ? 2u : 1u);
      const uint32_t code = which | (ih_ext >= ih_open ? 4u : 0u) |
                            (new_iv + ge_v >= new_s + go_v ? 8u : 0u);
      acc[k] |= code << (4 * (t & 7));
      if (i0 + k == t + 1) {  // cell (t+1, 0) enters the band: column-0 boundary
        new_s = col0[k];
        new_ih = kNeg;
      }
      nS[k] = new_s;
      nIh[k] = new_ih;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == km) {
        const int j = t + 1 - m;
        if (j >= 1 && j <= n && nS[k] > best) {
          best = nS[k];
          best_j = j;
        }
      }
    }
    if ((t & 7) == 7 || t == steps - 1) {
      *reinterpret_cast<int4*>(prow + (size_t)(t >> 3) * word_stride) =
          make_int4((int)acc[0], (int)acc[1], (int)acc[2], (int)acc[3]);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0u;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      S2[k] = S1[k];
      S1[k] = nS[k];
      Ih[k] = nIh[k];
      C[k] = nC[k];
      A[k] = An[k];
    }
    const float last_s = S1[K - 1], last_c = C[K - 1];
    float up_s = __shfl_up_sync(kFull, last_s, 1);
    float up_c = __shfl_up_sync(kFull, last_c, 1);
    if (lane == 31) {
      edge_s[t & 1][warp] = last_s;
      edge_c[t & 1][warp] = last_c;
    }
    __syncthreads();
    if (lane == 0) {
      up_s = warp ? edge_s[t & 1][warp - 1] : kNeg;
      up_c = warp ? edge_c[t & 1][warp - 1] : kNeg;
    }
    left_s2 = left_s1;
    left_s1 = up_s;
    left_c = up_c;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k == km) {
      score_out[r] = best;
      jend_out[r] = best_j;
    }
  }
}

// ---------------------------------------------------------------------------
// Traceback: one thread per row
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t lookup(const int32_t* __restrict__ plane, size_t word_stride,
                                           int jc, int ic) {
  if (jc <= 0) return 2u | 8u;  // column 0: a pure vertical-gap chain
  const int t = ic + jc - 1;
  const uint32_t word = (uint32_t)plane[(size_t)(t >> 3) * word_stride + ic];
  return (word >> (4 * (t & 7))) & 15u;
}

__global__ void traceback_kernel(const int32_t* __restrict__ ptr,
                                 const int32_t* __restrict__ jend,
                                 const int32_t* __restrict__ mrow, int n_rows, int mp,
                                 int m_max, uint8_t* __restrict__ is_gap,
                                 int32_t* __restrict__ jpos, int32_t* __restrict__ jbegin) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  uint8_t* gap_r = is_gap + (size_t)r * m_max;
  int32_t* pos_r = jpos + (size_t)r * m_max;
  for (int k = 0; k < m_max; ++k) {
    gap_r[k] = 0;
    pos_r[k] = 0;
  }
  const int32_t* plane = ptr + (size_t)r * mp;
  const size_t word_stride = (size_t)n_rows * mp;
  int i = mrow[r], j = jend[r];
  uint32_t byte = lookup(plane, word_stride, j, i);
  int cur = (int)(byte & 3u);
  while (i > 0) {
    const bool is_m = cur == 0, is_h = cur == 1, is_v = cur == 2;
    if (is_m || is_v) {
      gap_r[i - 1] = is_v ? 1 : 0;
      pos_r[i - 1] = j - 1;
    }
    const int ni = is_h ? i : i - 1;
    const int nj = is_v ? j : j - 1;
    const uint32_t nbyte = lookup(plane, word_stride, nj, ni);
    // the H-extend bit sits at the current cell, the V-extend bit at the
    // cell being stepped to (its source)
    const uint32_t ext = is_h ? (byte >> 2) & 1u : (nbyte >> 3) & 1u;
    const bool stay = !is_m && ext;
    cur = stay ? cur : (ni > 0 ? (int)(nbyte & 3u) : 0);
    i = ni;
    j = nj;
    byte = nbyte;
  }
  jbegin[r] = j;
}

// ---------------------------------------------------------------------------
// Factored Viterbi
// ---------------------------------------------------------------------------
struct ArgMax {
  float v;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;  // first max by index
}

// Block-wide max; `red` holds one float per warp and must not be rewritten
// before every thread has passed the next __syncthreads.
__device__ float block_max(float x, float* red, int lane, int warp, int nwarps) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, d));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ ArgMax block_argmax(ArgMax x, float* red_v, int* red_i, int lane, int warp,
                               int nwarps) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    ArgMax o{__shfl_xor_sync(kFull, x.v, d), __shfl_xor_sync(kFull, x.i, d)};
    x = better(x, o);
  }
  if (lane == 0) {
    red_v[warp] = x.v;
    red_i[warp] = x.i;
  }
  __syncthreads();
  ArgMax m{red_v[0], red_i[0]};
  for (int w = 1; w < nwarps; ++w) m = better(m, ArgMax{red_v[w], red_i[w]});
  return m;
}

// Inclusive prefix max over the block's lanes (state order).
__device__ float block_cummax(float x, float* red, int lane, int warp) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = fmaxf(x, y);
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x = fmaxf(x, red[w]);
  return x;
}

__global__ void __launch_bounds__(1024) viterbi_kernel(
    const float* __restrict__ obs, const int32_t* __restrict__ tact, int T, int S,
    const float* __restrict__ log_start, const float* __restrict__ log_end,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const int32_t* __restrict__ is_uni, const float* __restrict__ log_uni,
    const float* __restrict__ weights, const int32_t* __restrict__ prog,
    const float* __restrict__ trans_t, float log2pi_half, float* __restrict__ logp_out,
    int32_t* __restrict__ path_out, float* __restrict__ rows) {
  extern __shared__ float smem[];
  float* sc_s = smem;      // previous step's scores
  float* h_s = smem + S;   // one chain's flow
  __shared__ float red_a[32], red_b[2][32];
  __shared__ int red_i[2][32];
  const int b = blockIdx.x;
  const int v = threadIdx.x, lane = v & 31, warp = v >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool live = v < S;
  const float* x_b = obs + (size_t)b * T;
  float* rows_b = rows + (size_t)b * T * S;
  int32_t* path_b = path_out + (size_t)b * T;
  const int ta = tact[b];

  // per-thread taps of the factored transition: source lane and weight
  const int n_diag = prog[0], n_chain = prog[1];
  int n_entry[kMaxChains], n_exit[kMaxChains];
  int src[kMaxRolls];
  float wv[kMaxRolls], ramp[kMaxChains];
  int p = 2 + 2 * n_chain, wrow = 0, nroll = 0;
  for (int c = 0; c < n_chain; ++c) {
    n_entry[c] = prog[2 + 2 * c];
    n_exit[c] = prog[3 + 2 * c];
  }
  auto tap = [&](int o) {
    const int u = ((v - o) % S + S) % S;
    src[nroll] = u;
    wv[nroll] = live ? weights[(size_t)wrow * S + u] : kNeg;
    ++nroll;
    ++wrow;
  };
  for (int d = 0; d < n_diag; ++d) tap(prog[p++]);
  for (int c = 0; c < n_chain; ++c) {
    for (int e = 0; e < n_entry[c]; ++e) tap(prog[p++]);
    ramp[c] = live ? weights[(size_t)wrow * S + v] : 0.0f;
    ++wrow;
    for (int x = 0; x < n_exit[c]; ++x) tap(prog[p++]);
  }
  const float mu_v = live ? mu[v] : 0.0f;
  const float sig_v = live ? sigma[v] : 1.0f;
  const float lsig_v = log2pi_half - logf(sig_v);
  const bool uni_v = live && is_uni[v] != 0;
  const float luni_v = live ? log_uni[v] : 0.0f;
  auto emit = [&](float x) {
    const float z = (x - mu_v) / sig_v;
    const float norm = lsig_v - 0.5f * (z * z);
    return uni_v ? luni_v : norm;
  };

  // t = 0
  float score = live ? log_start[v] + emit(x_b[0]) : -INFINITY;
  float acc = block_max(score, red_b[0], lane, warp, nwarps);
  score = score - acc;
  if (live) {
    sc_s[v] = score;
    rows_b[v] = score;
  }
  __syncthreads();
  for (int t = 1; t < ta; ++t) {
    float out = kNeg;
    int k = 0;
    for (int d = 0; d < n_diag; ++d, ++k) {
      if (live) out = fmaxf(out, sc_s[src[k]] + wv[k]);
    }
    for (int c = 0; c < n_chain; ++c) {
      float inj = kNeg;
      for (int e = 0; e < n_entry[c]; ++e, ++k) {
        if (live) inj = fmaxf(inj, sc_s[src[k]] + wv[k]);
      }
      const float hx = block_cummax(live ? inj - ramp[c] : -INFINITY, red_a, lane, warp);
      if (live) h_s[v] = hx + ramp[c];
      __syncthreads();
      for (int x = 0; x < n_exit[c]; ++x, ++k) {
        if (live) out = fmaxf(out, h_s[src[k]] + wv[k]);
      }
      __syncthreads();
    }
    const float nw = live ? out + emit(x_b[t]) : -INFINITY;
    const float shift = block_max(nw, red_b[t & 1], lane, warp, nwarps);
    score = nw - shift;
    acc = acc + shift;
    if (live) {
      sc_s[v] = score;
      rows_b[(size_t)t * S + v] = score;
    }
    __syncthreads();
  }
  const ArgMax fin = block_argmax(ArgMax{live ? score + log_end[v] : -INFINITY, live ? v : S},
                                  red_b[0], red_i[0], lane, warp, nwarps);
  if (v == 0) logp_out[b] = fin.v + acc;
  for (int t = max(ta - 1, 0) + v; t < T; t += blockDim.x) path_b[t] = fin.i;
  __syncthreads();  // every thread has read red_b[0] before the walk reuses it
  // backward: re-find each visited state's first-max predecessor from the
  // stored score rows and the dense transition column
  int state = fin.i;
  for (int t = ta - 1; t >= 1; --t) {
    const float cand = live ? rows_b[(size_t)(t - 1) * S + v] + trans_t[(size_t)state * S + v]
                            : -INFINITY;
    const ArgMax bp = block_argmax(ArgMax{cand, live ? v : S}, red_b[t & 1], red_i[t & 1], lane,
                                   warp, nwarps);
    state = bp.i;
    if (v == 0) path_b[t - 1] = state;
  }
}

ffi::Error launch_status(const char* what) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(std::string(what) + ": " + cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error WaveFwdImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> sig, ffi::Buffer<ffi::F32> tmpl,
                       ffi::Buffer<ffi::S32> nact, ffi::Buffer<ffi::S32> mrow, float off,
                       float dmin, float go_h, float ge_h, float go_v, float ge_v,
                       ffi::ResultBuffer<ffi::S32> ptr, ffi::ResultBuffer<ffi::F32> score,
                       ffi::ResultBuffer<ffi::S32> jend) {
  const auto sd = sig.dimensions();
  const auto td = tmpl.dimensions();
  if (sd.size() != 2 || td.size() != 2 || td[0] != sd[0])
    return ffi::Error::InvalidArgument("wave_fwd: signals (R, N) and templates (R, MP) expected");
  const int n_rows = (int)sd[0], n_sig = (int)sd[1], mp = (int)td[1];
  if (mp % (32 * kRowsPerThread) != 0 || mp / kRowsPerThread > 512)
    return ffi::Error::InvalidArgument("wave_fwd: MP must be a multiple of 128, at most 2048");
  if (n_rows == 0) return ffi::Error::Success();
  wave_fwd_kernel<<<n_rows, mp / kRowsPerThread, 0, stream>>>(
      sig.typed_data(), tmpl.typed_data(), nact.typed_data(), mrow.typed_data(), n_sig, mp,
      n_rows, off, dmin, go_h, ge_h, go_v, ge_v, ptr->typed_data(), score->typed_data(),
      jend->typed_data());
  return launch_status("wave_fwd_kernel");
}

ffi::Error TracebackImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> ptr,
                         ffi::Buffer<ffi::S32> jend, ffi::Buffer<ffi::S32> mrow,
                         ffi::ResultBuffer<ffi::U8> is_gap, ffi::ResultBuffer<ffi::S32> jpos,
                         ffi::ResultBuffer<ffi::S32> jbegin) {
  const auto pd = ptr.dimensions();
  const auto gd = is_gap->dimensions();
  if (pd.size() != 3 || gd.size() != 2)
    return ffi::Error::InvalidArgument("traceback: ptr (ND8, R, MP) and is_gap (R, M) expected");
  const int n_rows = (int)pd[1], mp = (int)pd[2], m_max = (int)gd[1];
  if (n_rows == 0) return ffi::Error::Success();
  const int threads = 64;
  traceback_kernel<<<(n_rows + threads - 1) / threads, threads, 0, stream>>>(
      ptr.typed_data(), jend.typed_data(), mrow.typed_data(), n_rows, mp, m_max,
      is_gap->typed_data(), jpos->typed_data(), jbegin->typed_data());
  return launch_status("traceback_kernel");
}

ffi::Error ViterbiImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> obs, ffi::Buffer<ffi::S32> tact,
                       ffi::Buffer<ffi::F32> log_start, ffi::Buffer<ffi::F32> log_end,
                       ffi::Buffer<ffi::F32> mu, ffi::Buffer<ffi::F32> sigma,
                       ffi::Buffer<ffi::S32> is_uni, ffi::Buffer<ffi::F32> log_uni,
                       ffi::Buffer<ffi::F32> weights, ffi::Buffer<ffi::S32> prog,
                       ffi::Buffer<ffi::F32> trans_t, float log2pi_half,
                       ffi::ResultBuffer<ffi::F32> logp, ffi::ResultBuffer<ffi::S32> path,
                       ffi::ResultBuffer<ffi::F32> rows) {
  const auto od = obs.dimensions();
  const int B = (int)od[0], T = (int)od[1], S = (int)log_start.dimensions()[0];
  if (S < 1 || S > 1024) return ffi::Error::InvalidArgument("viterbi: 1..1024 states");
  if (B == 0 || T == 0) return ffi::Error::Success();
  const int threads = (S + 31) / 32 * 32;
  viterbi_kernel<<<B, threads, 2 * S * sizeof(float), stream>>>(
      obs.typed_data(), tact.typed_data(), T, S, log_start.typed_data(), log_end.typed_data(),
      mu.typed_data(), sigma.typed_data(), is_uni.typed_data(), log_uni.typed_data(),
      weights.typed_data(), prog.typed_data(), trans_t.typed_data(), log2pi_half,
      logp->typed_data(), path->typed_data(), rows->typed_data());
  return launch_status("viterbi_kernel");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(StriqueWaveFwd, WaveFwdImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<float>("dist_offset")
                                  .Attr<float>("dist_min")
                                  .Attr<float>("gap_open_h")
                                  .Attr<float>("gap_extension_h")
                                  .Attr<float>("gap_open_v")
                                  .Attr<float>("gap_extension_v")
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(StriqueTraceback, TracebackImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(StriqueViterbi, ViterbiImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Attr<float>("log2pi_half")
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
