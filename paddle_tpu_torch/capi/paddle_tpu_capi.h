/* paddle_tpu_torch C inference API.
 *
 * The pure-C deployment surface of Paddle's capi (capi.h: paddle_init,
 * paddle_gradient_machine_create_for_inference,
 * paddle_gradient_machine_forward; example
 * capi/examples/model_inference/dense/main.c), with the JAX package's
 * pd_tpu_* names and signatures unchanged, so a C program written against
 * paddle_tpu/capi/paddle_tpu_capi.h builds against this header.
 *
 * A model is an artifact directory written by
 * paddle_tpu_torch.fluid.aot.export_inference_artifact: a torch.export
 * program (__inference__.pt2) with the trained parameters baked in, whose
 * forward calls the hand-written CUDA kernels as torch.library operators.
 * This C layer hosts it through an embedded CPython and PyTorch runtime
 * (Paddle's capi likewise links its full C++ runtime behind the C
 * surface). The artifact runs on the device it was exported on: the card,
 * or the CPU where it was exported with fluid.CPUPlace().
 */

#ifndef PADDLE_TPU_CAPI_H
#define PADDLE_TPU_CAPI_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
  PD_TPU_OK = 0,
  PD_TPU_ERROR = 1,
  PD_TPU_NOT_INITIALIZED = 2,
} pd_tpu_error;

typedef void* pd_tpu_model;

/* Initialize the embedded runtime (Py_Initialize). Mirrors
 * paddle_init(argc, argv). Forces no device: each model runs on the
 * device its artifact was exported on. Safe to call once per process. */
pd_tpu_error pd_tpu_init(void);

/* Load an AOT artifact directory (aot.export_inference_artifact output).
 * Mirrors paddle_gradient_machine_create_for_inference. */
pd_tpu_error pd_tpu_model_load(const char* artifact_dir, pd_tpu_model* out);

/* Run the model on one dense float32 input [batch, feature_dim] and copy
 * the FIRST fetch into out_data (caller-allocated, out_capacity floats).
 * out_rows/out_cols receive the fetch shape. Mirrors the dense example's
 * forward (capi/examples/model_inference/dense/main.c).
 *
 * Thread safety: after pd_tpu_init, every entry point acquires the Python
 * GIL internally — any number of threads may run concurrently against
 * shared or distinct models (the reference's multi_thread example
 * contract); Python-side work serializes on the GIL. */
pd_tpu_error pd_tpu_model_run(pd_tpu_model model, const float* in_data,
                              int64_t batch, int64_t feature_dim,
                              float* out_data, int64_t out_capacity,
                              int64_t* out_rows, int64_t* out_cols);

/* Run a SEQUENCE model: ids is the concatenation of n_seqs int64 token
 * sequences, seq_lens their lengths (the reference capi's
 * paddle_ivector sequence feed, examples/model_inference/sequence/
 * main.c). The model's (single) feed must be a lod_level=1 var; the
 * FIRST fetch is copied to out_data as with pd_tpu_model_run. */
pd_tpu_error pd_tpu_model_run_seq(pd_tpu_model model, const int64_t* ids,
                                  const int64_t* seq_lens, int64_t n_seqs,
                                  float* out_data, int64_t out_capacity,
                                  int64_t* out_rows, int64_t* out_cols);

/* Destroy a loaded model. */
pd_tpu_error pd_tpu_model_destroy(pd_tpu_model model);

/* Tear down the embedded runtime. MUST be called from the thread that
 * called pd_tpu_init (Py_Finalize needs the interpreter's main thread
 * state); all other entry points are thread-agnostic. */
pd_tpu_error pd_tpu_shutdown(void);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_CAPI_H */
