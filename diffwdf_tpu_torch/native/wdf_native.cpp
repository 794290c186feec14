// Native (CPU) WDF runtime: Wright-omega math library + real-time-style
// clipper engines.  A copy of the JAX package's diffwdf_tpu/native/
// wdf_native.cpp, the same C API.
//
// Role parity with the reference's native stack:
//  - toms917 Wright-omega library -> the real-line omega here (the audio
//    path only evaluates omega on the real axis; see
//    Toms917DiodePair.h:64-67).  Implementation: region-split initial guess
//    + Halley iterations in log space to double precision, no branch-cut
//    machinery needed on the real line.
//  - chowdsp wdft templates + RTNeural MLP inference (DiodeClipperWDF.h,
//    DiodePairNeuralModel.h) -> the per-sample clipper engines below: a
//    single-core CPU baseline, a deployable CPU path for trained models, and
//    an independent float64 oracle for tests.
//
// C API only (consumed via ctypes from diffwdf_tpu_torch.native.lib).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Wright omega, real line: solve w + log(w) = x.
// ---------------------------------------------------------------------------

static inline double omega_core(double x, int iters) {
  // initial guess for u = log(w)
  double u;
  if (x <= -1.0) {
    u = x - std::exp(x);
  } else if (x >= 2.0) {
    double lx = std::log(x);
    u = std::log(x - lx + lx / x);
  } else {
    double t = x - 1.0;
    u = std::log(1.0 + 0.5 * t + 0.0625 * t * t);
  }
  // Halley iterations on f(u) = e^u + u - x (cubic convergence; 3 suffice
  // for full double precision from the guesses above)
  for (int i = 0; i < iters; ++i) {
    double eu = std::exp(u);
    double f = eu + u - x;
    double fp = eu + 1.0;
    double fpp = eu;
    u -= f / (fp - 0.5 * f * fpp / fp);
  }
  return std::exp(u);
}

double wdf_wrightomega(double x) { return omega_core(x, 3); }

void wdf_wrightomega_batch(const double* x, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = omega_core(x[i], 3);
}

// ---------------------------------------------------------------------------
// Analytic diode-pair clipper: Vs(R) || C with the eqn-45 asymmetric root.
// ---------------------------------------------------------------------------

struct ClipperCoeffs {
  double p1R;       // Vs-port scatter coefficient of the parallel adaptor
  double log_up;    // log(R Is / (n_up Vt))
  double log_dn;    // log(R Is / (n_down Vt))
  double inv_up;    // 1 / (n_up Vt)
  double inv_dn;    // 1 / (n_down Vt)
  double two_vt;
  double n_up, n_dn;
};

static ClipperCoeffs make_coeffs(double r_source, double cap, double fs,
                                 double Is, double vt_eff, double n_up,
                                 double n_dn) {
  ClipperCoeffs c;
  double r_c = 1.0 / (2.0 * cap * fs);
  double g = 1.0 / r_source + 1.0 / r_c;
  double r_up = 1.0 / g;
  c.p1R = (1.0 / r_source) / g;
  c.log_up = std::log(r_up * Is / (n_up * vt_eff));
  c.log_dn = std::log(r_up * Is / (n_dn * vt_eff));
  c.inv_up = 1.0 / (n_up * vt_eff);
  c.inv_dn = 1.0 / (n_dn * vt_eff);
  c.two_vt = 2.0 * vt_eff;
  c.n_up = n_up;
  c.n_dn = n_dn;
  return c;
}

// Process one buffer; state (capacitor z) is carried in/out through *z.
void wdf_clipper_process(const float* in, float* out, int64_t n, double* z_io,
                         double r_source, double cap, double fs, double Is,
                         double vt_eff, double n_up, double n_dn) {
  ClipperCoeffs c = make_coeffs(r_source, cap, fs, Is, vt_eff, n_up, n_dn);
  double z = *z_io;
  for (int64_t i = 0; i < n; ++i) {
    double v = (double)in[i];
    double b_temp = -c.p1R * (z - v);
    double a = z + b_temp;
    double lam = (a > 0.0) - (a < 0.0);
    bool pos = a >= 0.0;
    double mu0 = pos ? c.n_dn : c.n_up;
    double mu1 = pos ? c.n_up : c.n_dn;
    double log0 = pos ? c.log_dn : c.log_up;
    double log1 = pos ? c.log_up : c.log_dn;
    double inv0 = pos ? c.inv_dn : c.inv_up;
    double inv1 = pos ? c.inv_up : c.inv_dn;
    double la = lam * a;
    double b_root =
        a - c.two_vt * lam *
                (mu0 * omega_core(log0 + la * inv0, 3) -
                 mu1 * omega_core(log1 - la * inv1, 3));
    double z_new = b_root + b_temp;
    out[i] = (float)(0.5 * (z_new + z));
    z = z_new;
  }
  *z_io = z;
}

// ---------------------------------------------------------------------------
// Neural clipper: MLP root (dense/tanh stack), weights in flat arrays.
// Layout: for each layer l with sizes (in_l, out_l): kernel row-major
// [in_l][out_l], then bias [out_l]; act[l] = 1 -> tanh, 0 -> linear.
// Input to the net is [a, logR]; output predicts the NEGATED reflected wave
// (reference sign convention, DiodePairNeuralModel.h:68-73).
// ---------------------------------------------------------------------------

void wdf_clipper_process_neural(const float* in, float* out, int64_t n,
                                double* z_io, double r_source, double cap,
                                double fs, const float* weights,
                                const int32_t* sizes, const int32_t* acts,
                                int32_t n_layers) {
  double r_c = 1.0 / (2.0 * cap * fs);
  double g = 1.0 / r_source + 1.0 / r_c;
  double r_up = 1.0 / g;
  double p1R = (1.0 / r_source) / g;
  float log_r = (float)std::log(r_up);

  // max layer width for scratch
  int maxw = 2;
  for (int l = 0; l <= n_layers; ++l)
    if (sizes[l] > maxw) maxw = sizes[l];
  std::vector<float> buf_a(maxw), buf_b(maxw);

  double z = *z_io;
  for (int64_t i = 0; i < n; ++i) {
    double v = (double)in[i];
    double b_temp = -p1R * (z - v);
    double a = z + b_temp;

    float* cur = buf_a.data();
    float* nxt = buf_b.data();
    cur[0] = (float)a;
    cur[1] = log_r;
    const float* w = weights;
    for (int l = 0; l < n_layers; ++l) {
      int in_l = sizes[l], out_l = sizes[l + 1];
      const float* bias = w + (size_t)in_l * out_l;
      for (int o = 0; o < out_l; ++o) nxt[o] = bias[o];
      for (int ii = 0; ii < in_l; ++ii) {
        float xi = cur[ii];
        const float* row = w + (size_t)ii * out_l;
        for (int o = 0; o < out_l; ++o) nxt[o] += xi * row[o];
      }
      if (acts[l]) {
        for (int o = 0; o < out_l; ++o) nxt[o] = std::tanh(nxt[o]);
      }
      w = bias + out_l;
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    double b_root = -(double)cur[0];
    double z_new = b_root + b_temp;
    out[i] = (float)(0.5 * (z_new + z));
    z = z_new;
  }
  *z_io = z;
}

// ---------------------------------------------------------------------------
// CSV measurement loader (dataimport parity, native speed): parses the
// reference dataset format, returns sample rate and fills (vin, vout).
// Two-pass: call with data == nullptr to get the row count.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <cstring>
#include <cstdlib>

int64_t wdf_load_csv(const char* path, float* vin, float* vout,
                     int64_t capacity, double* fs_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  double fs = 0.0;
  int header_rows = 0;
  int64_t count = 0;
  // header: 9 comment-ish rows then a column-title row then data
  while (std::fgets(line, sizeof line, f)) {
    if (header_rows < 10) {
      if (std::strncmp(line, "#Sample rate:", 13) == 0) {
        fs = atof(line + 13);
      }
      header_rows++;
      continue;
    }
    double a, b;
    if (std::sscanf(line, "%lf,%lf", &a, &b) == 2) {
      if (vin && count < capacity) {
        vin[count] = (float)a;
        vout[count] = (float)b;
      }
      count++;
    }
  }
  std::fclose(f);
  if (fs_out) *fs_out = fs;
  return count;
}

}  // extern "C"
