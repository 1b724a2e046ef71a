// Forward-mode dual numbers for the node-linearization kernel.
//
// Dual<S> carries a value and ONE tangent. Where K1 takes a column of a
// Jacobian by forward mode (a control direction's dtau/ds, the Euler
// step's base block, a slot's residual block), one thread evaluates the
// function once in Dual<S> along its basis vector and reads the column off
// the tangents. Comparisons and selects act on the value (pv), which
// matches jnp.where: the derivative is the selected branch's.
#pragma once

#include <cmath>

template <class S>
struct Dual {
  S v, d;
  __host__ __device__ Dual() : v(0), d(0) {}
  __host__ __device__ Dual(S v_) : v(v_), d(0) {}
  __host__ __device__ Dual(S v_, S d_) : v(v_), d(d_) {}
};

template <class S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, Dual<S> b) { return Dual<S>(a.v + b.v, a.d + b.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, S b) { return Dual<S>(a.v + b, a.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator+(S a, Dual<S> b) { return Dual<S>(a + b.v, b.d); }

template <class S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a) { return Dual<S>(-a.v, -a.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, Dual<S> b) { return Dual<S>(a.v - b.v, a.d - b.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, S b) { return Dual<S>(a.v - b, a.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator-(S a, Dual<S> b) { return Dual<S>(a - b.v, -b.d); }

template <class S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, Dual<S> b) { return Dual<S>(a.v * b.v, a.d * b.v + a.v * b.d); }
template <class S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, S b) { return Dual<S>(a.v * b, a.d * b); }
template <class S>
__device__ __forceinline__ Dual<S> operator*(S a, Dual<S> b) { return Dual<S>(a * b.v, a * b.d); }

template <class S>
__device__ __forceinline__ Dual<S> operator/(Dual<S> a, Dual<S> b) {
  S q = a.v / b.v;
  return Dual<S>(q, (a.d - q * b.d) / b.v);
}
template <class S>
__device__ __forceinline__ Dual<S> operator/(Dual<S> a, S b) { return Dual<S>(a.v / b, a.d / b); }
template <class S>
__device__ __forceinline__ Dual<S> operator/(S a, Dual<S> b) {
  S q = a / b.v;
  return Dual<S>(q, -q * b.d / b.v);
}

template <class S>
__device__ __forceinline__ Dual<S>& operator+=(Dual<S>& a, Dual<S> b) { a = a + b; return a; }
template <class S>
__device__ __forceinline__ Dual<S>& operator-=(Dual<S>& a, Dual<S> b) { a = a - b; return a; }

// value of a scalar or a dual
__device__ __forceinline__ float pv(float x) { return x; }
__device__ __forceinline__ double pv(double x) { return x; }
template <class S>
__device__ __forceinline__ S pv(Dual<S> x) { return x.v; }

// elementary functions on scalars and duals
__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ double vsin(double x) { return sin(x); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ double vcos(double x) { return cos(x); }
__device__ __forceinline__ float vatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double vatan2(double y, double x) { return atan2(y, x); }

// sine and cosine of one argument (for a dual, one call of each)
__device__ __forceinline__ void vsincos(float x, float* s, float* c) {
  *s = sinf(x);
  *c = cosf(x);
}
__device__ __forceinline__ void vsincos(double x, double* s, double* c) {
  *s = sin(x);
  *c = cos(x);
}

template <class S>
__device__ __forceinline__ void vsincos(Dual<S> x, Dual<S>* s, Dual<S>* c) {
  S sv, cv;
  vsincos(x.v, &sv, &cv);
  *s = Dual<S>(sv, cv * x.d);
  *c = Dual<S>(cv, -sv * x.d);
}

template <class S>
__device__ __forceinline__ Dual<S> vsqrt(Dual<S> x) {
  S r = vsqrt(x.v);
  return Dual<S>(r, x.d / (S(2) * r));
}
template <class S>
__device__ __forceinline__ Dual<S> vsin(Dual<S> x) { return Dual<S>(vsin(x.v), vcos(x.v) * x.d); }
template <class S>
__device__ __forceinline__ Dual<S> vcos(Dual<S> x) { return Dual<S>(vcos(x.v), -vsin(x.v) * x.d); }
template <class S>
__device__ __forceinline__ Dual<S> vatan2(Dual<S> y, Dual<S> x) {
  S den = x.v * x.v + y.v * y.v;
  return Dual<S>(vatan2(y.v, x.v), (x.v * y.d - y.v * x.d) / den);
}
