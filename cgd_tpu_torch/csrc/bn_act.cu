// K-bn: the CLIP ResNet tower's folded BatchNorm, residual add and ReLU in
// one pass each way, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this chain as XLA ops
// (cgd_tpu/models/clip/model.py). The port's chain was five to seven
// PyTorch kernels a site forward (widen, multiply, add, narrow, [add,] ReLU)
// and four backward (threshold_backward, widen, multiply, narrow), each a
// full pass over the activation. Here the same arithmetic, with the same
// roundings, runs in one pass:
//
//   mode A  y = relu(T(x*s + b))
//   mode B  y = relu(T(T(x*s + b) + r))                     r: the identity
//   mode C  y = relu(T(T(x*s + b) + T(r*sd + bd)))          r: the down conv
//
// where x*s + b is an f32 multiply then an f32 add (__fmul_rn / __fadd_rn:
// never contracted into an FMA, as PyTorch's separate kernels do not), T is
// the activation's dtype (bf16: round to nearest even; f32: nothing), and
// relu is PyTorch's clamp_min (a NaN passes, else fmaxf(v, 0)). Backward,
// from the saved y alone:
//
//   g = y <= 0 ? 0 : dy            (threshold_backward)
//   dx = T(g * s); dr = g (mode B) or T(g * sd) (mode C)
//
// so the result is bit-equal to the chain, forward and backward, at bf16
// and f32 (tests/test_torch_port_bn_act_cuda.py).
//
// Bound: bytes (a few FLOPs an element). Each input is read once and each
// output written once; no atomics, no host synchronisation, so a step
// containing it captures into a CUDA graph.
// Two ways through memory, one launch a call:
//  * channels last (the channel stride 1, C a multiple of the vector): the
//    grid's threads are laid over (pixel lane, channel vector) so that a
//    thread keeps one channel vector for its whole grid-stride walk down
//    the pixels: its s / b (and sd / bd) are read once, into registers;
//  * anything else (an NCHW tensor seen as NHWC, as the tower's stem hands
//    it; C not a multiple of the vector; a pointer off 16 bytes): a thread
//    an element, its channel (m / inner) % C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cgd {
namespace bnact {

enum Mode { A = 0, B = 1, C = 2 };

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads an SM
constexpr int UNROLL = 2;         // vectors a thread has in flight (channels last)

// the activation's type: its rounding and its 16-byte vector
template <typename T>
struct Act;

template <>
struct Act<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static void load(const void* p, long long i, float* f) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(p) + i), f);
  }
  __device__ static void store(void* p, long long i, const float* f) {
    reinterpret_cast<uint4*>(p)[i] = pack8(f);
  }
  __device__ static float load1(const void* p, long long m) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[m]);
  }
  __device__ static void store1(void* p, long long m, float v) {
    reinterpret_cast<__nv_bfloat16*>(p)[m] = __float2bfloat16_rn(v);
  }
};

template <>
struct Act<float> {
  static constexpr int VEC = 4;
  __device__ static float round(float v) { return v; }
  __device__ static void load(const void* p, long long i, float* f) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ static void store(void* p, long long i, const float* f) {
    reinterpret_cast<float4*>(p)[i] = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static float load1(const void* p, long long m) {
    return reinterpret_cast<const float*>(p)[m];
  }
  __device__ static void store1(void* p, long long m, float v) {
    reinterpret_cast<float*>(p)[m] = v;
  }
};

// a channel's factors: the site's scale and bias, the down branch's
struct Chan {
  float s, b, sd, bd;
};

template <int MODE, bool BWD>
__device__ __forceinline__ Chan chan(const float* s, const float* b, const float* sd,
                                     const float* bd, int ch) {
  Chan k;
  k.s = __ldg(s + ch);
  k.b = BWD ? 0.0f : __ldg(b + ch);
  k.sd = MODE == C ? __ldg(sd + ch) : 0.0f;
  k.bd = MODE == C && !BWD ? __ldg(bd + ch) : 0.0f;
  return k;
}

// one element forward; x, r: the inputs' values (exact in T)
template <typename T, int MODE>
__device__ __forceinline__ float fwd1(float x, float r, const Chan& k) {
  float v = Act<T>::round(__fadd_rn(__fmul_rn(x, k.s), k.b));
  if (MODE != A) {
    const float id = MODE == C ? Act<T>::round(__fadd_rn(__fmul_rn(r, k.sd), k.bd)) : r;
    v = Act<T>::round(__fadd_rn(v, id));
  }
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// one element backward: dx, and dr for modes B and C
template <typename T, int MODE>
__device__ __forceinline__ void bwd1(float y, float dy, const Chan& k, float& dx, float& dr) {
  const float g = y <= 0.0f ? 0.0f : dy;
  dx = Act<T>::round(__fmul_rn(g, k.s));
  dr = MODE == C ? Act<T>::round(__fmul_rn(g, k.sd)) : g;
}

// The pointers of one launch. Forward: in0 = x, in1 = r, out0 = y.
// Backward: in0 = y, in1 = dy, out0 = dx, out1 = dr.
struct Args {
  const void* in0;
  const void* in1;
  const float* s;
  const float* b;
  const float* sd;
  const float* bd;
  void* out0;
  void* out1;
  long long n;      // elements
  int c;            // channels
  long long inner;  // the channel's stride, in elements
};

// U vectors of VEC elements (those with ok[q]), every load made before the
// first store; kv(q, j): the factors of element j of vector q
template <typename T, int MODE, bool BWD, int U, typename K>
__device__ __forceinline__ void vec_ops(const Args& a, const long long (&i)[U],
                                        const bool (&ok)[U], K kv) {
  constexpr int V = Act<T>::VEC;
  constexpr bool TWO_IN = BWD || MODE != A;
  float u[U][V], w[U][V];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (!ok[q]) continue;
    Act<T>::load(a.in0, i[q], u[q]);
    if (TWO_IN) Act<T>::load(a.in1, i[q], w[q]);
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (!ok[q]) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (BWD) {
        bwd1<T, MODE>(u[q][j], w[q][j], kv(q, j), u[q][j], w[q][j]);
      } else {
        u[q][j] = fwd1<T, MODE>(u[q][j], TWO_IN ? w[q][j] : 0.0f, kv(q, j));
      }
    }
    Act<T>::store(a.out0, i[q], u[q]);
    if (BWD && MODE != A) Act<T>::store(a.out1, i[q], w[q]);
  }
}

// Channels last, C % VEC == 0: thread t keeps channel vector t % G (G = C /
// VEC) and walks the pixels t / G, t / G + P, ... (P = the grid's threads /
// G); its factors are read once.
template <typename T, int MODE, bool BWD>
__global__ void __launch_bounds__(THREADS) channels_last_kernel(Args a) {
  constexpr int V = Act<T>::VEC;
  const long long groups = a.c / V;
  const long long rows = a.n / a.c;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long lanes = (long long)gridDim.x * THREADS / groups;
  if (tid >= lanes * groups) return;
  const int g = (int)(tid % groups);
  Chan k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = chan<MODE, BWD>(a.s, a.b, a.sd, a.bd, g * V + j);
  const auto kv = [&](int, int j) -> const Chan& { return k[j]; };
  for (long long p = tid / groups; p < rows; p += UNROLL * lanes) {
    long long i[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      i[q] = (p + q * lanes) * groups + g;
      ok[q] = p + q * lanes < rows;
    }
    vec_ops<T, MODE, BWD>(a, i, ok, kv);
  }
}

// Any layout: a thread an element.
template <typename T, int MODE, bool BWD>
__global__ void __launch_bounds__(THREADS) elements_kernel(Args a) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long m = (long long)blockIdx.x * THREADS + threadIdx.x; m < a.n; m += stride) {
    const Chan k = chan<MODE, BWD>(a.s, a.b, a.sd, a.bd, (int)((m / a.inner) % a.c));
    const float u = Act<T>::load1(a.in0, m);
    const float w = (BWD || MODE != A) ? Act<T>::load1(a.in1, m) : 0.0f;
    if (BWD) {
      float dx, dr;
      bwd1<T, MODE>(u, w, k, dx, dr);
      Act<T>::store1(a.out0, m, dx);
      if (MODE != A) Act<T>::store1(a.out1, m, dr);
    } else {
      Act<T>::store1(a.out0, m, fwd1<T, MODE>(u, w, k));
    }
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int MODE, bool BWD>
int launch(const Args& a, int sms, cudaStream_t stream) {
  constexpr int V = Act<T>::VEC;
  const long long vecs = a.n / V;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const bool aligned = aligned16(a.in0) && aligned16(a.in1) && aligned16(a.out0) &&
                       aligned16(a.out1) && aligned16(a.s) && aligned16(a.b) &&
                       aligned16(a.sd) && aligned16(a.bd);
  if (aligned && a.inner == 1 && a.c % V == 0 && a.c / V <= cap * THREADS) {
    long long blocks = (vecs + THREADS - 1) / THREADS;
    blocks = blocks < cap ? blocks : cap;
    channels_last_kernel<T, MODE, BWD><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  } else {
    long long blocks = (a.n + THREADS - 1) / THREADS;
    blocks = blocks < cap ? blocks : cap;
    elements_kernel<T, MODE, BWD><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(const Args& a, int mode, int f32, int sms, cudaStream_t stream) {
  switch (mode * 2 + (f32 ? 1 : 0)) {
    case 0: return launch<__nv_bfloat16, A, BWD>(a, sms, stream);
    case 1: return launch<float, A, BWD>(a, sms, stream);
    case 2: return launch<__nv_bfloat16, B, BWD>(a, sms, stream);
    case 3: return launch<float, B, BWD>(a, sms, stream);
    case 4: return launch<__nv_bfloat16, C, BWD>(a, sms, stream);
    case 5: return launch<float, C, BWD>(a, sms, stream);
  }
  return (int)cudaErrorInvalidValue;
}

inline bool valid(const Args& a, int mode, int sms) {
  return a.n > 0 && a.c > 0 && a.inner > 0 && sms > 0 && mode >= A && mode <= C &&
         a.n % ((long long)a.c * a.inner) == 0 && a.in0 && a.s && a.out0 &&
         (mode == A || a.in1) && (mode != C || a.sd);
}

}  // namespace bnact
}  // namespace cgd

// y = relu(T(x*s + b) [+ r]) in `mode` 0 / 1 / 2 (A / B / C above); x, r and
// y share one layout: n elements, c channels, the channel's stride `inner`.
// s, b, sd, bd: f32 [c]. f32: the activations are f32, else bf16.
extern "C" int cgd_bn_act_fwd(const void* x, const void* r, const void* s, const void* b,
                              const void* sd, const void* bd, void* y, long long n, int c,
                              long long inner, int mode, int f32, int sms, void* stream) {
  using namespace cgd::bnact;
  const Args a{x, mode == A ? nullptr : r, static_cast<const float*>(s),
               static_cast<const float*>(b), static_cast<const float*>(sd),
               static_cast<const float*>(bd), y, nullptr, n, c, inner};
  if (!valid(a, mode, sms) || !b || (mode == C && !bd)) return (int)cudaErrorInvalidValue;
  return dispatch<false>(a, mode, f32, sms, static_cast<cudaStream_t>(stream));
}

// dx = T(g * s), dr = g (mode 1) or T(g * sd) (mode 2), g = y <= 0 ? 0 : dy;
// y, dy, dx and dr share one layout.
extern "C" int cgd_bn_act_bwd(const void* y, const void* dy, const void* s, const void* sd,
                              void* dx, void* dr, long long n, int c, long long inner, int mode,
                              int f32, int sms, void* stream) {
  using namespace cgd::bnact;
  const Args a{y, dy, static_cast<const float*>(s), nullptr, static_cast<const float*>(sd),
               nullptr, dx, mode == A ? nullptr : dr, n, c, inner};
  if (!valid(a, mode, sms) || !dy || (mode != A && !dr)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(a, mode, f32, sms, static_cast<cudaStream_t>(stream));
}
