// C ABI of the port's kernels, loaded with ctypes by repro_torch/kernels/build.py.
// Each entry launches on the given stream and returns cudaGetLastError()
// (0 when the launch was accepted); the Python wrapper raises otherwise.
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {
cudaError_t launch_icws_sketch(const float* w, const int* keys, const float* vals,
                               int B, int N, int m, uint32_t seed, int S, int* fp,
                               float* val, float* amin, int* argkey, int* packed,
                               cudaStream_t stream);
cudaError_t launch_estimate_fields(const int* fq, const float* vq, const int* fc,
                                   const float* vc, long long fc_fs, long long fc_rs,
                                   long long vc_fs, long long vc_rs, const int* qmap,
                                   const int* cmap, int G, int Q, int P, int m,
                                   float* cnt, float* sw, cudaStream_t stream);
cudaError_t launch_countsketch_sparse(const int* keys, const float* vals, int B, int N,
                                      int W, int R, uint32_t seed, float* out,
                                      cudaStream_t stream);
cudaError_t launch_jl_sketch(const int* keys, const float* vals, int B, int N, int m,
                             int tile, uint32_t seed, float* out, cudaStream_t stream);
cudaError_t launch_linear_estimate_fields(const float* tq, const float* tc,
                                          long long tc_fs, long long tc_ps,
                                          const int* qmap, const int* cmap, int G,
                                          int Q, int P, int R, int W, float* out,
                                          cudaStream_t stream);
cudaError_t launch_dmh_sketch(const float* w, const int* keys, const float* vals,
                              int B, int n, int c, int m, uint32_t seed, int J,
                              int cluster, int threads, int* fp, float* val,
                              float* amin, int* argkey, int* packed,
                              cudaStream_t stream);
cudaError_t launch_sample_estimate_fields(
    const int* kq, const float* vq, const float* aq, const int* kc, const float* vc,
    const float* tc, long long kc_fs, long long kc_rs, long long vc_fs,
    long long vc_rs, long long tc_fs, long long tc_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int S, int per, float* out,
    cudaStream_t stream);
cudaError_t launch_estimate_fields_packed(const int* fq, const float* vq, const int* fc,
                                          const int* wc, long long fc_fs,
                                          long long fc_rs, long long wc_fs,
                                          long long wc_rs, const int* qmap,
                                          const int* cmap, int G, int Q, int P, int m,
                                          float* cnt, float* sw, cudaStream_t stream);
cudaError_t launch_estimate_many(const int* fq, const float* vq, const int* fc,
                                 const float* vc, long long fc_rs, long long vc_rs,
                                 int Q, int P, int m, float* cnt, float* sw,
                                 cudaStream_t stream);
cudaError_t launch_estimate_pairs(const int* fa, const float* va, const int* fb,
                                  const float* vb, long long fa_rs, long long va_rs,
                                  long long fb_rs, long long vb_rs, int P, int m,
                                  float* cnt, float* sw, cudaStream_t stream);
cudaError_t launch_estimate_one_vs_many(const int* fq, const float* vq, const int* fc,
                                        const float* vc, long long fc_rs,
                                        long long vc_rs, int P, int m, float* cnt,
                                        float* sw, cudaStream_t stream);
cudaError_t launch_linear_estimate_fields_packed(const float* tq, const int* wc,
                                                 long long wc_fs, long long wc_ps,
                                                 const int* qmap, const int* cmap,
                                                 int G, int Q, int P, int R, int W,
                                                 float* out, cudaStream_t stream);
cudaError_t launch_sample_estimate_fields_packed(
    const int* kq, const float* vq, const float* aq, const int* kc, const int* wc,
    const float* tc, long long kc_fs, long long kc_rs, long long wc_fs,
    long long wc_rs, long long tc_fs, long long tc_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int Sq, int Sc, int per,
    float* out, cudaStream_t stream);
cudaError_t launch_countsketch_dense(const float* x, long long T, int W, int R,
                                     uint32_t seed, uint32_t offset, int chunk,
                                     float* scratch, float* out, cudaStream_t stream);
cudaError_t launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16, int BH, int T, int S, int D, int group,
                                   int causal, int window, long long q_offset,
                                   long long k_offset, float scale, cudaStream_t stream);
}  // namespace repro

extern "C" {

int repro_icws_sketch(const float* w, const int* keys, const float* vals, int B,
                      int N, int m, uint32_t seed, int S, int* fp, float* val,
                      float* amin, int* argkey, int* packed, void* stream) {
  return (int)repro::launch_icws_sketch(w, keys, vals, B, N, m, seed, S, fp, val,
                                        amin, argkey, packed, (cudaStream_t)stream);
}

int repro_estimate_fields(const int* fq, const float* vq, const int* fc,
                          const float* vc, long long fc_fs, long long fc_rs,
                          long long vc_fs, long long vc_rs, const int* qmap,
                          const int* cmap, int G, int Q, int P, int m, float* cnt,
                          float* sw, void* stream) {
  return (int)repro::launch_estimate_fields(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs,
                                            vc_rs, qmap, cmap, G, Q, P, m, cnt, sw,
                                            (cudaStream_t)stream);
}

int repro_countsketch_sparse(const int* keys, const float* vals, int B, int N, int W,
                             int R, uint32_t seed, float* out, void* stream) {
  return (int)repro::launch_countsketch_sparse(keys, vals, B, N, W, R, seed, out,
                                               (cudaStream_t)stream);
}

int repro_jl_sketch(const int* keys, const float* vals, int B, int N, int m, int tile,
                    uint32_t seed, float* out, void* stream) {
  return (int)repro::launch_jl_sketch(keys, vals, B, N, m, tile, seed, out,
                                      (cudaStream_t)stream);
}

int repro_linear_estimate_fields(const float* tq, const float* tc, long long tc_fs,
                                 long long tc_ps, const int* qmap, const int* cmap,
                                 int G, int Q, int P, int R, int W, float* out,
                                 void* stream) {
  return (int)repro::launch_linear_estimate_fields(tq, tc, tc_fs, tc_ps, qmap, cmap, G,
                                                   Q, P, R, W, out,
                                                   (cudaStream_t)stream);
}

int repro_dmh_sketch(const float* w, const int* keys, const float* vals, int B,
                     int n, int c, int m, uint32_t seed, int J, int cluster,
                     int threads, int* fp, float* val, float* amin, int* argkey,
                     int* packed, void* stream) {
  return (int)repro::launch_dmh_sketch(w, keys, vals, B, n, c, m, seed, J, cluster,
                                       threads, fp, val, amin, argkey, packed,
                                       (cudaStream_t)stream);
}

int repro_sample_estimate_fields(const int* kq, const float* vq, const float* aq,
                                 const int* kc, const float* vc, const float* tc,
                                 long long kc_fs, long long kc_rs, long long vc_fs,
                                 long long vc_rs, long long tc_fs, long long tc_rs,
                                 const int* qmap, const int* cmap, int G, int Q,
                                 int P, int S, int per, float* out, void* stream) {
  return (int)repro::launch_sample_estimate_fields(
      kq, vq, aq, kc, vc, tc, kc_fs, kc_rs, vc_fs, vc_rs, tc_fs, tc_rs, qmap, cmap,
      G, Q, P, S, per, out, (cudaStream_t)stream);
}

int repro_estimate_fields_packed(const int* fq, const float* vq, const int* fc,
                                 const int* wc, long long fc_fs, long long fc_rs,
                                 long long wc_fs, long long wc_rs, const int* qmap,
                                 const int* cmap, int G, int Q, int P, int m,
                                 float* cnt, float* sw, void* stream) {
  return (int)repro::launch_estimate_fields_packed(fq, vq, fc, wc, fc_fs, fc_rs, wc_fs,
                                                   wc_rs, qmap, cmap, G, Q, P, m, cnt,
                                                   sw, (cudaStream_t)stream);
}

int repro_estimate_many(const int* fq, const float* vq, const int* fc,
                        const float* vc, long long fc_rs, long long vc_rs, int Q,
                        int P, int m, float* cnt, float* sw, void* stream) {
  return (int)repro::launch_estimate_many(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt,
                                          sw, (cudaStream_t)stream);
}

int repro_estimate_pairs(const int* fa, const float* va, const int* fb,
                         const float* vb, long long fa_rs, long long va_rs,
                         long long fb_rs, long long vb_rs, int P, int m, float* cnt,
                         float* sw, void* stream) {
  return (int)repro::launch_estimate_pairs(fa, va, fb, vb, fa_rs, va_rs, fb_rs, vb_rs,
                                           P, m, cnt, sw, (cudaStream_t)stream);
}

int repro_estimate_one_vs_many(const int* fq, const float* vq, const int* fc,
                               const float* vc, long long fc_rs, long long vc_rs, int P,
                               int m, float* cnt, float* sw, void* stream) {
  return (int)repro::launch_estimate_one_vs_many(fq, vq, fc, vc, fc_rs, vc_rs, P, m, cnt,
                                                 sw, (cudaStream_t)stream);
}

int repro_linear_estimate_fields_packed(const float* tq, const int* wc, long long wc_fs,
                                        long long wc_ps, const int* qmap,
                                        const int* cmap, int G, int Q, int P, int R,
                                        int W, float* out, void* stream) {
  return (int)repro::launch_linear_estimate_fields_packed(
      tq, wc, wc_fs, wc_ps, qmap, cmap, G, Q, P, R, W, out, (cudaStream_t)stream);
}

int repro_sample_estimate_fields_packed(const int* kq, const float* vq,
                                        const float* aq, const int* kc, const int* wc,
                                        const float* tc, long long kc_fs,
                                        long long kc_rs, long long wc_fs,
                                        long long wc_rs, long long tc_fs,
                                        long long tc_rs, const int* qmap,
                                        const int* cmap, int G, int Q, int P, int Sq,
                                        int Sc, int per, float* out, void* stream) {
  return (int)repro::launch_sample_estimate_fields_packed(
      kq, vq, aq, kc, wc, tc, kc_fs, kc_rs, wc_fs, wc_rs, tc_fs, tc_rs, qmap, cmap, G,
      Q, P, Sq, Sc, per, out, (cudaStream_t)stream);
}

int repro_countsketch_dense(const float* x, long long T, int W, int R, uint32_t seed,
                            uint32_t offset, int chunk, float* scratch, float* out,
                            void* stream) {
  return (int)repro::launch_countsketch_dense(x, T, W, R, seed, offset, chunk, scratch,
                                              out, (cudaStream_t)stream);
}

int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int bf16,
                          int BH, int T, int S, int D, int group, int causal, int window,
                          long long q_offset, long long k_offset, float scale,
                          void* stream) {
  return (int)repro::launch_flash_attention(q, k, v, o, bf16, BH, T, S, D, group, causal,
                                            window, q_offset, k_offset, scale,
                                            (cudaStream_t)stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
