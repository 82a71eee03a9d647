// Exact division by a constant of the launch: cdiv(a, d) is the IEEE quotient
// RN(a / b), bit for bit, for a divisor b fixed on the host (the grid
// spacings, 3), without the IEEE division's range check and slow path.
//
// With y = RN(1/b) computed once on the host, q = RN(a*y) is within an ulp
// or so of a/b, the remainder r = a - q*b is exact in one FMA, and
// RN(q + r*y) is the correctly rounded quotient (Markstein's correction).
// That holds while nothing underflows or overflows, so it is taken for a
// numerator whose exponent lies in a window set by b's. Below the window (a
// tiny or subnormal numerator, common in a solver's far field) a is scaled
// up by 2^S, which is exact, divided the same way and scaled back, which is
// exact when the quotient is a normal number (taken from the binade above
// the least normal one: the scaled quotient has more precision below it, so
// a quotient that rounds up into that binade is left to the fallback). A
// zero takes a*y, which has
// the quotient's sign. What is left (a subnormal quotient, values near
// overflow, inf, NaN) takes the IEEE division, out of line. __fma_rn /
// __fmaf_rn are never split or fused by -fmad=false, so the sequence rounds
// exactly as written.
//
// The window, for precision p, exponents [emin, emax] and b's exponent eb:
// a's exponent ea >= emin + p keeps r exact (r is a multiple of
// 2^(ea - 2p + 1), so of the least subnormal); eb + emin + 2 <= ea <=
// eb + emax - 2 keeps q normal and finite; ea <= emax - 2 keeps q*b and a
// finite with a margin. S = 4p lifts every subnormal above emin + 2p and
// keeps every number below the window under 2^(emin + 5p), inside the
// window unless b is huge or tiny (the scaled numerator is checked again).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

// The divisor b, y = RN(1/b) and the window [lo, hi) of the magnitudes of
// the numerators that take the corrected product: the powers of two that
// bound the exponents below (an empty window, lo > hi, when b or 1/b is not
// a normal number).
template <typename T>
struct CDiv {
  T b, y, lo, hi;
};

template <typename T>
struct CDivFormat;
template <>
struct CDivFormat<float> {
  static constexpr int p = 24, emin = -126, emax = 127, bias = 127;
  static constexpr float up = 0x1p96f, down = 0x1p-96f;  // 2^S, 2^-S, S = 4p
};
template <>
struct CDivFormat<double> {
  static constexpr int p = 53, emin = -1022, emax = 1023, bias = 1023;
  static constexpr double up = 0x1p212, down = 0x1p-212;
};

// On the host, from the divisor already rounded to T.
template <typename T>
CDiv<T> make_cdiv(T b) {
  using F = CDivFormat<T>;
  const T y = T(1) / b;
  CDiv<T> d{b, y, T(1), T(0)};
  if (std::isnormal(b) && std::isnormal(y)) {
    int e;
    std::frexp(b, &e);
    const int eb = e - 1;
    const int lo = std::max(F::emin + F::p, eb + F::emin + 2);
    const int hi = std::min(F::emax - 2, eb + F::emax - 2);
    if (lo <= hi) {
      d.lo = std::ldexp(T(1), lo);
      d.hi = std::ldexp(T(1), hi + 1);
    }
  }
  return d;
}

__device__ __forceinline__ unsigned cdiv_exponent(float a) {
  return (__float_as_uint(a) >> 23) & 0xffu;
}
__device__ __forceinline__ unsigned cdiv_exponent(double a) {
  return (unsigned)((unsigned long long)__double_as_longlong(a) >> 52) & 0x7ffu;
}
__device__ __forceinline__ float cdiv_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double cdiv_abs(double a) { return fabs(a); }
__device__ __forceinline__ float cdiv_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double cdiv_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The IEEE division, kept out of line: the kernels that call cdiv carry no
// division sequence of their own, only a call on the cold branch.
template <typename T>
__device__ __noinline__ T cdiv_ieee(T a, T b) {
  return a / b;
}

// Whether |a| lies in d's window (false for a NaN): two compares.
template <typename T>
__device__ __forceinline__ bool cdiv_in_window(T a, const CDiv<T>& d) {
  const T m = cdiv_abs(a);
  return (m >= d.lo) & (m < d.hi);
}

// RN(a*y) corrected to RN(a / b), for a in the window.
template <typename T>
__device__ __forceinline__ T cdiv_corrected(T a, const CDiv<T>& d) {
  const T q = a * d.y;
  return cdiv_fma(cdiv_fma(-q, d.b, a), d.y, q);
}

template <typename T>
__device__ __forceinline__ T cdiv(T a, const CDiv<T>& d) {
  if (cdiv_in_window(a, d)) return cdiv_corrected(a, d);
  if (a == T(0)) return a * d.y;
  if (cdiv_abs(a) < d.lo) {
    const T u = a * CDivFormat<T>::up;
    if (cdiv_in_window(u, d)) {
      const T q = cdiv_corrected(u, d) * CDivFormat<T>::down;
      if (cdiv_exponent(q) > 1) return q;  // |q| >= 2^(emin+1): a/b was normal too
    }
  }
  return cdiv_ieee(a, d.b);
}

// The division policies of stokes.cuh's term functions. CDivExact is cdiv.
// CDivFast is the corrected product alone, branch-free (a zero selects
// a*y), recording in `ok` whether every numerator lay in the window or was
// zero; where it did not, the caller computes again with CDivExact. So the
// compiler schedules a cell's divisions as straight-line code.
struct CDivExact {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, const CDiv<T>& d) const {
    return cdiv(a, d);
  }
};
struct CDivFast {
  bool ok = true;
  template <typename T>
  __device__ __forceinline__ T operator()(T a, const CDiv<T>& d) {
    const T q = a * d.y;
    const bool zero = a == T(0);
    ok = ok & (cdiv_in_window(a, d) | zero);
    return zero ? q : cdiv_fma(cdiv_fma(-q, d.b, a), d.y, q);
  }
};

// A phase of divisions `phase(dv)`: branch-free with CDivFast, and again
// with CDivExact where a numerator left its window.
template <typename F>
__device__ __forceinline__ void retry_passes(const F& phase) {
  CDivFast fast;
  phase(fast);
  if (!fast.ok) phase(CDivExact());
}
