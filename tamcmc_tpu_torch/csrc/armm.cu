// The ARMM solver's fixed-count bisection as one forward and one backward
// kernel, hand-written for Hopper (sm_90a), with plain `extern "C"`
// launchers bound through ctypes (tamcmc_tpu_torch/ops/armm_kernel.py).
//
// Replaces no TPU kernel.  The reference's loop
// (tamcmc_tpu/ops/armm.py, mixed_mode_frequencies: 45 halvings of
// jnp.where over every interval between two tangent poles) is jnp code that
// XLA fuses into one loop.  Left as eager torch, each halving was ~30 small
// kernels over the whole (walkers, slots) tensor and ~5 more in autograd's
// backward: ~1,600 launches a step in the dense cell, each reading and
// writing a few MB, the host unable to issue them as fast as the card ran
// them.
//
// What bounds it: the FP32 pipe and instruction dispatch, not bytes.  Per
// (walker, slot) the forward reads lo and hi and writes the root and a
// 64-bit mask of decisions (20 B in float32; the walker's ten scalars are
// one 40-B row shared by its slots), while each halving issues two tanf
// (each a three-part Cody-Waite reduction and a polynomial), two IEEE
// divisions and ~20 other float operations: 99 SASS instructions on the
// common path (armm_kernel.INSTR_PER_HALVING), so the 45 halvings of the
// dense cell's 64,512 x 60 brackets take at least 0.52 ms at the card's
// 128 lane-instructions a clock an SM, its 77 MB of traffic 0.02 ms.
// So the design keeps everything in registers: one thread per (walker,
// slot) runs all halvings with lo, hi and the walker's scalars in
// registers, and stores only the root and the decisions.  The backward
// reads the upstream gradient and the mask and writes the gradients of the
// two bracket ends (24 B a slot in float32) after 45 steps of three adds and
// a multiply.
//
// Bit for bit.  The plain loop (ops/armm.py bisect_plain) runs, per halving,
//   mid = 0.5 * (lo + hi)
//   x = mid / dnu
//   u = x - nmax_x
//   tp = pi * (((x - eps_p) - delta0l / dnu) - (0.5 * alpha_p) * (u * u))
//   y = 1e6 / (dpi1 * mid)
//   v = y - pi0_x
//   tg = pi * ((y - eps_g) - (0.5 * alpha_g) * (v * v))
//   pos = tan(tp) - q * tan(tg) > 0
//   lo, hi = pos ? (lo, mid) : (mid, hi)
// as torch ops in Python's order of evaluation, each rounded once (pow with
// exponent 2 is ATen's base * base; pi the float nearest math.pi).  Here
// every step is one __f*_rn / __d*_rn intrinsic, which the compiler never
// contracts into an FMA, and tan is tanf / tan, the functions ATen's CUDA
// tan kernel calls; delta0l / dnu, 0.5 alpha_p and 0.5 alpha_g are the same
// in every halving and are formed once.  So the roots and the decisions are
// the plain loop's on the card.
//
// The backward replays the decisions in reverse.  autograd's graph of the
// plain loop gives, with Glo, Ghi the gradients of lo, hi after a halving:
//   freqs = 0.5 (lo + hi):        Glo = Ghi = 0.5 g
//   lo' = where(pos, lo, mid):    lo gets where(pos, Glo, 0), mid the other
//   hi' = where(pos, mid, hi):    mid gets where(pos, Ghi, 0), hi the other
//   mid = 0.5 (lo + hi):          Gs = 0.5 (Gmid), added to lo's and hi's
// and at every node exactly two terms meet: Gmid = (pos ? Ghi : Glo) + 0,
// Glo = (pos ? Glo : 0) + Gs, Ghi = (pos ? 0 : Ghi) + Gs.  A sum of two
// terms is the same in either order, so this is autograd's gradient bit for
// bit (a -0 becomes +0 where the engine adds the where's zero, as there).
// The decisions get no gradient, as in the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BISECT = 64;     // decisions a mask holds (armm_kernel.py)
constexpr int ROW = 10;            // walker scalars a row (armm_kernel.py)

template <typename T> struct Rn;

template <> struct Rn<float> {
    static __device__ __forceinline__ float add(float a, float b)
    { return __fadd_rn(a, b); }
    static __device__ __forceinline__ float sub(float a, float b)
    { return __fsub_rn(a, b); }
    static __device__ __forceinline__ float mul(float a, float b)
    { return __fmul_rn(a, b); }
    static __device__ __forceinline__ float div(float a, float b)
    { return __fdiv_rn(a, b); }
    static __device__ __forceinline__ float tan(float a) { return tanf(a); }
};

template <> struct Rn<double> {
    static __device__ __forceinline__ double add(double a, double b)
    { return __dadd_rn(a, b); }
    static __device__ __forceinline__ double sub(double a, double b)
    { return __dsub_rn(a, b); }
    static __device__ __forceinline__ double mul(double a, double b)
    { return __dmul_rn(a, b); }
    static __device__ __forceinline__ double div(double a, double b)
    { return __ddiv_rn(a, b); }
    static __device__ __forceinline__ double tan(double a) { return ::tan(a); }
};

// One thread per (walker, slot) of the n = walkers x slots brackets.  `rows`
// holds each walker's dnu, eps_p, dpi1, eps_g, q, delta0l, alpha_p, nmax_x,
// alpha_g, pi0_x; `mask` gets decision k of the slot in bit k.
template <typename T>
__global__ void __launch_bounds__(THREADS)
armm_bisect_fwd_kernel(const T* __restrict__ lo0, const T* __restrict__ hi0,
                       const T* __restrict__ rows, T* __restrict__ freqs,
                       unsigned long long* __restrict__ mask, long long n,
                       int slots, int n_bisect)
{
    using R = Rn<T>;
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n)
        return;
    const T* r = rows + (i / slots) * ROW;
    const T dnu = r[0], eps_p = r[1], dpi1 = r[2], eps_g = r[3], q = r[4];
    const T nmax_x = r[7], pi0_x = r[9];
    const T d0 = R::div(r[5], dnu);            // delta0l / dnu
    const T hap = R::mul(T(0.5), r[6]);        // 0.5 * alpha_p
    const T hag = R::mul(T(0.5), r[8]);        // 0.5 * alpha_g
    const T pi = T(3.141592653589793);         // math.pi in T, to nearest
    const T big = T(1e6);
    T lo = lo0[i], hi = hi0[i];
    unsigned long long bits = 0;
    for (int k = 0; k < n_bisect; ++k) {
        const T mid = R::mul(R::add(lo, hi), T(0.5));
        const T x = R::div(mid, dnu);
        const T u = R::sub(x, nmax_x);
        const T tp = R::mul(pi, R::sub(R::sub(R::sub(x, eps_p), d0),
                                       R::mul(hap, R::mul(u, u))));
        const T y = R::div(big, R::mul(dpi1, mid));
        const T v = R::sub(y, pi0_x);
        const T tg = R::mul(pi, R::sub(R::sub(y, eps_g),
                                       R::mul(hag, R::mul(v, v))));
        const bool pos = R::sub(R::tan(tp), R::mul(q, R::tan(tg))) > T(0);
        bits |= (unsigned long long)pos << k;
        lo = pos ? lo : mid;
        hi = pos ? mid : hi;
    }
    freqs[i] = R::mul(R::add(lo, hi), T(0.5));
    mask[i] = bits;
}

// The gradients of the n brackets' ends from the upstream gradient of their
// roots and the forward's decisions (the recurrence in the note above).
template <typename T>
__global__ void __launch_bounds__(THREADS)
armm_bisect_bwd_kernel(const T* __restrict__ g,
                       const unsigned long long* __restrict__ mask,
                       T* __restrict__ glo, T* __restrict__ ghi, long long n,
                       int n_bisect)
{
    using R = Rn<T>;
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n)
        return;
    const unsigned long long bits = mask[i];
    const T zero = T(0);
    T gl = R::mul(g[i], T(0.5));
    T gh = gl;
    for (int k = n_bisect - 1; k >= 0; --k) {
        const bool pos = (bits >> k) & 1ull;
        const T gs = R::mul(R::add(pos ? gh : gl, zero), T(0.5));
        gl = R::add(pos ? gl : zero, gs);
        gh = R::add(pos ? zero : gh, gs);
    }
    glo[i] = gl;
    ghi[i] = gh;
}

inline unsigned blocks(long long n)
{
    return (unsigned)((n + THREADS - 1) / THREADS);
}

template <typename T>
int launch_fwd(const void* lo, const void* hi, const void* rows, void* freqs,
               void* mask, long long n, int slots, int n_bisect,
               void* stream)
{
    if (n <= 0 || slots <= 0 || n_bisect < 0 || n_bisect > MAX_BISECT)
        return (int)cudaErrorInvalidValue;
    armm_bisect_fwd_kernel<T><<<blocks(n), THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const T*)lo, (const T*)hi, (const T*)rows, (T*)freqs,
        (unsigned long long*)mask, n, slots, n_bisect);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* mask, void* glo, void* ghi,
               long long n, int n_bisect, void* stream)
{
    if (n <= 0 || n_bisect < 0 || n_bisect > MAX_BISECT)
        return (int)cudaErrorInvalidValue;
    armm_bisect_bwd_kernel<T><<<blocks(n), THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const T*)g, (const unsigned long long*)mask, (T*)glo, (T*)ghi, n,
        n_bisect);
    return (int)cudaGetLastError();
}

}  // namespace

// lo, hi, freqs: n = walkers x slots values, walker-major; rows: walkers x
// 10 scalars; mask: n 64-bit words.  Returns the CUDA error code.
extern "C" int armm_bisect_fwd(const void* lo, const void* hi,
                               const void* rows, void* freqs, void* mask,
                               long long n, int slots, int n_bisect,
                               void* stream)
{
    return launch_fwd<float>(lo, hi, rows, freqs, mask, n, slots, n_bisect,
                             stream);
}

extern "C" int armm_bisect_fwd_f64(const void* lo, const void* hi,
                                   const void* rows, void* freqs, void* mask,
                                   long long n, int slots, int n_bisect,
                                   void* stream)
{
    return launch_fwd<double>(lo, hi, rows, freqs, mask, n, slots, n_bisect,
                              stream);
}

// g, glo, ghi: n values; mask: the forward's n words.
extern "C" int armm_bisect_bwd(const void* g, const void* mask, void* glo,
                               void* ghi, long long n, int n_bisect,
                               void* stream)
{
    return launch_bwd<float>(g, mask, glo, ghi, n, n_bisect, stream);
}

extern "C" int armm_bisect_bwd_f64(const void* g, const void* mask,
                                   void* glo, void* ghi, long long n,
                                   int n_bisect, void* stream)
{
    return launch_bwd<double>(g, mask, glo, ghi, n, n_bisect, stream);
}
