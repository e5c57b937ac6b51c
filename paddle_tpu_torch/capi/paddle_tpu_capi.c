/* paddle_tpu_torch C inference API implementation: CPython embedding.
 *
 * See paddle_tpu_capi.h. Paddle's capi wraps its C++ runtime
 * (capi/gradient_machine.cpp); here the runtime is the Python-hosted
 * torch.export loader (paddle_tpu_torch.fluid.aot.load_inference_artifact),
 * embedded through the CPython C API.
 *
 * Threading contract: after pd_tpu_init the GIL is released; every entry
 * point takes it with PyGILState_Ensure, so any number of threads may call
 * concurrently on shared or distinct models (the contract of Paddle's
 * multi_thread example). The Python side of a forward serializes on the
 * GIL; PyTorch releases it inside its kernels.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "paddle_tpu_capi.h"

static int g_initialized = 0;
static PyThreadState* g_main_ts = NULL;

typedef struct {
  PyObject* artifact; /* paddle_tpu_torch.fluid.aot.InferenceArtifact */
} model_t;

pd_tpu_error pd_tpu_init(void) {
  if (g_initialized) return PD_TPU_OK;
  Py_Initialize();
  /* no device is forced: an artifact runs on the device it was exported
   * on (the manifest's), and loading one whose device is absent fails */
  /* release the GIL so other threads can Ensure it */
  g_main_ts = PyEval_SaveThread();
  g_initialized = 1;
  return PD_TPU_OK;
}

pd_tpu_error pd_tpu_model_load(const char* artifact_dir, pd_tpu_model* out) {
  if (!g_initialized) return PD_TPU_NOT_INITIALIZED;
  if (!out) return PD_TPU_ERROR;
  PyGILState_STATE gs = PyGILState_Ensure();
  pd_tpu_error rc = PD_TPU_ERROR;
  PyObject* mod = NULL;
  PyObject* loader = NULL;
  PyObject* artifact = NULL;
  model_t* m = NULL;

  mod = PyImport_ImportModule("paddle_tpu_torch.fluid.aot");
  if (!mod) goto done;
  loader = PyObject_GetAttrString(mod, "load_inference_artifact");
  if (!loader) goto done;
  artifact = PyObject_CallFunction(loader, "s", artifact_dir);
  if (!artifact) goto done;
  m = (model_t*)malloc(sizeof(model_t));
  if (!m) goto done;
  m->artifact = artifact;
  artifact = NULL; /* ownership moved */
  *out = (pd_tpu_model)m;
  rc = PD_TPU_OK;

done:
  if (rc != PD_TPU_OK && PyErr_Occurred()) PyErr_Print();
  Py_XDECREF(artifact);
  Py_XDECREF(loader);
  Py_XDECREF(mod);
  PyGILState_Release(gs);
  return rc;
}

/* Shared tail: feed {name0: value} -> artifact.run -> copy first fetch out.
 * Steals the reference to `value`. GIL must be held. */
static pd_tpu_error run_with_value(model_t* m, PyObject* value,
                                   float* out_data, int64_t out_capacity,
                                   int64_t* out_rows, int64_t* out_cols) {
  pd_tpu_error rc = PD_TPU_ERROR;
  PyObject* feed_names = NULL;
  PyObject* name0 = NULL;
  PyObject* feed = NULL;
  PyObject* outs = NULL;
  PyObject* first = NULL;
  PyObject* shape = NULL;
  PyObject* f32 = NULL;
  PyObject* buf = NULL;
  long rows = 1, cols = 1;

  feed_names = PyObject_GetAttrString(m->artifact, "feed_names");
  if (!feed_names) goto done;
  name0 = PySequence_GetItem(feed_names, 0);
  if (!name0) goto done;
  feed = PyDict_New();
  if (!feed) goto done;
  if (PyDict_SetItem(feed, name0, value) != 0) goto done;

  outs = PyObject_CallMethod(m->artifact, "run", "O", feed);
  if (!outs) goto done;
  first = PySequence_GetItem(outs, 0);
  if (!first) goto done;

  shape = PyObject_GetAttrString(first, "shape");
  if (!shape || !PyTuple_Check(shape)) goto done;
  {
    Py_ssize_t nd = PyTuple_Size(shape);
    if (nd >= 1) rows = PyLong_AsLong(PyTuple_GetItem(shape, 0));
    if (nd >= 2) cols = PyLong_AsLong(PyTuple_GetItem(shape, 1));
    if (PyErr_Occurred()) goto done;
  }
  if (out_rows) *out_rows = rows;
  if (out_cols) *out_cols = cols;
  if (rows * cols > out_capacity) {
    fprintf(stderr, "pd_tpu capi: output %ldx%ld exceeds out_capacity\n",
            rows, cols);
    goto done;
  }

  f32 = PyObject_CallMethod(first, "astype", "s", "float32");
  if (!f32) goto done;
  buf = PyObject_CallMethod(f32, "tobytes", NULL);
  if (!buf) goto done;
  {
    char* p = PyBytes_AsString(buf);
    if (!p) goto done;
    memcpy(out_data, p, (size_t)(rows * cols * 4));
  }
  rc = PD_TPU_OK;

done:
  if (rc != PD_TPU_OK && PyErr_Occurred()) PyErr_Print();
  Py_XDECREF(buf);
  Py_XDECREF(f32);
  Py_XDECREF(shape);
  Py_XDECREF(first);
  Py_XDECREF(outs);
  Py_XDECREF(feed);
  Py_XDECREF(name0);
  Py_XDECREF(feed_names);
  Py_DECREF(value);
  return rc;
}

/* numpy.frombuffer(bytes, dtype).reshape(...) helper; returns new ref or
 * NULL. GIL must be held. */
static PyObject* np_from_bytes(const void* data, Py_ssize_t nbytes,
                               const char* dtype) {
  PyObject* np = NULL;
  PyObject* frombuffer = NULL;
  PyObject* raw = NULL;
  PyObject* flat = NULL;

  np = PyImport_ImportModule("numpy");
  if (!np) goto done;
  frombuffer = PyObject_GetAttrString(np, "frombuffer");
  if (!frombuffer) goto done;
  raw = PyBytes_FromStringAndSize((const char*)data, nbytes);
  if (!raw) goto done;
  flat = PyObject_CallFunction(frombuffer, "Os", raw, dtype);

done:
  Py_XDECREF(raw);
  Py_XDECREF(frombuffer);
  Py_XDECREF(np);
  return flat;
}

pd_tpu_error pd_tpu_model_run(pd_tpu_model model, const float* in_data,
                              int64_t batch, int64_t feature_dim,
                              float* out_data, int64_t out_capacity,
                              int64_t* out_rows, int64_t* out_cols) {
  if (!g_initialized) return PD_TPU_NOT_INITIALIZED;
  if (!model || !in_data || !out_data) return PD_TPU_ERROR;
  model_t* m = (model_t*)model;
  PyGILState_STATE gs = PyGILState_Ensure();
  pd_tpu_error rc = PD_TPU_ERROR;

  PyObject* flat = np_from_bytes(in_data,
                                 (Py_ssize_t)(batch * feature_dim * 4),
                                 "float32");
  if (!flat) goto done;
  PyObject* arr = PyObject_CallMethod(flat, "reshape", "ll", (long)batch,
                                      (long)feature_dim);
  Py_DECREF(flat);
  if (!arr) goto done;
  rc = run_with_value(m, arr, out_data, out_capacity, out_rows, out_cols);

done:
  if (rc != PD_TPU_OK && PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gs);
  return rc;
}

pd_tpu_error pd_tpu_model_run_seq(pd_tpu_model model, const int64_t* ids,
                                  const int64_t* seq_lens, int64_t n_seqs,
                                  float* out_data, int64_t out_capacity,
                                  int64_t* out_rows, int64_t* out_cols) {
  if (!g_initialized) return PD_TPU_NOT_INITIALIZED;
  if (!model || !ids || !seq_lens || n_seqs <= 0) return PD_TPU_ERROR;
  model_t* m = (model_t*)model;
  PyGILState_STATE gs = PyGILState_Ensure();
  pd_tpu_error rc = PD_TPU_ERROR;
  PyObject* seq_list = NULL;

  /* list of [len_i, 1] int64 arrays — the fluid LoD feed form the
   * artifact's run() packs into its (data, lens) spec */
  seq_list = PyList_New((Py_ssize_t)n_seqs);
  if (!seq_list) goto done;
  {
    int64_t off = 0;
    for (int64_t i = 0; i < n_seqs; ++i) {
      int64_t ln = seq_lens[i];
      if (ln < 0) goto done;
      PyObject* flat = np_from_bytes(ids + off, (Py_ssize_t)(ln * 8),
                                     "int64");
      if (!flat) goto done;
      PyObject* arr = PyObject_CallMethod(flat, "reshape", "ll", (long)ln,
                                          1L);
      Py_DECREF(flat);
      if (!arr) goto done;
      PyList_SET_ITEM(seq_list, (Py_ssize_t)i, arr); /* steals arr */
      off += ln;
    }
  }
  rc = run_with_value(m, seq_list, out_data, out_capacity, out_rows,
                      out_cols);
  seq_list = NULL; /* consumed */

done:
  if (rc != PD_TPU_OK && PyErr_Occurred()) PyErr_Print();
  Py_XDECREF(seq_list);
  PyGILState_Release(gs);
  return rc;
}

pd_tpu_error pd_tpu_model_destroy(pd_tpu_model model) {
  model_t* m = (model_t*)model;
  if (m) {
    if (g_initialized) {
      PyGILState_STATE gs = PyGILState_Ensure();
      Py_XDECREF(m->artifact);
      PyGILState_Release(gs);
    }
    free(m);
  }
  return PD_TPU_OK;
}

pd_tpu_error pd_tpu_shutdown(void) {
  if (g_initialized) {
    if (g_main_ts) PyEval_RestoreThread(g_main_ts);
    g_main_ts = NULL;
    Py_Finalize();
    g_initialized = 0;
  }
  return PD_TPU_OK;
}
