// Native map-index engine: the host-side bookkeeping hot path.
//
// The reference keeps its covisibility graph and observation maps in
// mutex-guarded pointer structures updated incrementally
// (KeyFrame::UpdateConnections, MapPoint::mObservations).  The TPU engine
// recomputes them from the SoA binding table kf_kp_lm on demand; these
// kernels are the C++ runtime part of that design — called once or more per
// frame by the orchestrator, they walk the (max_kf, max_kp) int32 table
// with simple counting loops that beat the numpy fancy-indexing equivalents
// and keep the Python layer free of per-row temporaries.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>

extern "C" {

// Count, for every keyframe, how many landmarks it shares with `kf_id`.
// kf_kp_lm: (n_kf, max_kp) int32, NO_LM = -1; lm_seen: scratch (max_lm) u8
// (zeroed inside); out: (n_kf) int32.
void covisibility_counts(const int32_t* kf_kp_lm,
                         const uint8_t* kf_valid,
                         int64_t n_kf, int64_t max_kp, int64_t max_lm,
                         int64_t kf_id,
                         uint8_t* lm_seen,
                         int32_t* out) {
  std::memset(lm_seen, 0, static_cast<size_t>(max_lm));
  const int32_t* row = kf_kp_lm + kf_id * max_kp;
  for (int64_t i = 0; i < max_kp; ++i) {
    int32_t lm = row[i];
    if (lm >= 0 && lm < max_lm) lm_seen[lm] = 1;
  }
  for (int64_t k = 0; k < n_kf; ++k) {
    int32_t c = 0;
    if (kf_valid[k] && k != kf_id) {
      const int32_t* r = kf_kp_lm + k * max_kp;
      for (int64_t i = 0; i < max_kp; ++i) {
        int32_t lm = r[i];
        if (lm >= 0 && lm < max_lm && lm_seen[lm]) ++c;
      }
    }
    out[k] = c;
  }
}

// Per-landmark observation counts over valid keyframes.
void landmark_obs_counts(const int32_t* kf_kp_lm,
                         const uint8_t* kf_valid,
                         int64_t n_kf, int64_t max_kp, int64_t max_lm,
                         int32_t* out) {
  std::memset(out, 0, static_cast<size_t>(max_lm) * sizeof(int32_t));
  for (int64_t k = 0; k < n_kf; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* r = kf_kp_lm + k * max_kp;
    for (int64_t i = 0; i < max_kp; ++i) {
      int32_t lm = r[i];
      if (lm >= 0 && lm < max_lm) ++out[lm];
    }
  }
}

// Flatten live observations of the given keyframes into COO arrays.
// Returns the number of observations written (caller sizes buffers at
// n_sel * max_kp worst case).
int64_t observations_coo(const int32_t* kf_kp_lm,
                         int64_t max_kp,
                         const int32_t* kf_ids, int64_t n_sel,
                         int32_t* out_kf, int32_t* out_kp, int32_t* out_lm) {
  int64_t n = 0;
  for (int64_t s = 0; s < n_sel; ++s) {
    int32_t k = kf_ids[s];
    const int32_t* r = kf_kp_lm + static_cast<int64_t>(k) * max_kp;
    for (int64_t i = 0; i < max_kp; ++i) {
      int32_t lm = r[i];
      if (lm >= 0) {
        out_kf[n] = k;
        out_kp[n] = static_cast<int32_t>(i);
        out_lm[n] = lm;
        ++n;
      }
    }
  }
  return n;
}

// Replace every binding of landmark `b` with landmark `a` (MapPoint::Replace
// core) and return how many bindings changed.
int64_t replace_landmark(int32_t* kf_kp_lm, int64_t total,
                         int32_t b, int32_t a) {
  int64_t n = 0;
  for (int64_t i = 0; i < total; ++i) {
    if (kf_kp_lm[i] == b) {
      kf_kp_lm[i] = a;
      ++n;
    }
  }
  return n;
}

}  // extern "C"
