/* Multi-threaded C inference example, after Paddle's
 * capi/examples/model_inference/multi_thread/main.c:29-35: N threads
 * forward CONCURRENTLY against one loaded model.
 *
 * Contract (see paddle_tpu_capi.h): every entry point acquires the Python
 * GIL internally, so concurrent pd_tpu_model_run calls on a shared model
 * are safe and serialize on the GIL (Paddle's example clones per-thread
 * gradient machines instead; here the artifact is immutable, so sharing
 * needs no clone). Each thread checks its own results for correctness.
 *
 * Usage: multi_thread_infer <artifact_dir> <feature_dim>
 */

#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>

#include "../../../paddle_tpu_capi.h"

#define NUM_THREAD 4
#define RUNS_PER_THREAD 3

typedef struct {
  pd_tpu_model model;
  long feat;
  int tid;
  int ok;
  float first_prob; /* probs[0] of the deterministic per-thread input */
} worker_arg;

static void* worker(void* p) {
  worker_arg* a = (worker_arg*)p;
  a->ok = 0;

  float* input = (float*)malloc(sizeof(float) * a->feat);
  if (!input) return NULL;
  for (long i = 0; i < a->feat; ++i) {
    /* deterministic per-thread input so runs are checkable */
    input[i] = (float)((i + a->tid) % 5) * 0.25f - 0.5f;
  }

  float output[256];
  float prev0 = -1.f;
  for (int r = 0; r < RUNS_PER_THREAD; ++r) {
    int64_t rows = 0, cols = 0;
    if (pd_tpu_model_run(a->model, input, 1, a->feat, output, 256, &rows,
                         &cols) != PD_TPU_OK) {
      fprintf(stderr, "thread %d run %d failed\n", a->tid, r);
      free(input);
      return NULL;
    }
    float sum = 0.f;
    for (int64_t j = 0; j < cols; ++j) sum += output[j];
    if (sum < 0.99f || sum > 1.01f) {
      fprintf(stderr, "thread %d: probs sum %.4f\n", a->tid, sum);
      free(input);
      return NULL;
    }
    if (r > 0 && output[0] != prev0) {
      fprintf(stderr, "thread %d: non-deterministic output\n", a->tid);
      free(input);
      return NULL;
    }
    prev0 = output[0];
  }
  a->first_prob = prev0;
  a->ok = 1;
  free(input);
  return NULL;
}

int main(int argc, char* argv[]) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <artifact_dir> <feature_dim>\n", argv[0]);
    return 2;
  }

  if (pd_tpu_init() != PD_TPU_OK) return 1;
  pd_tpu_model model = NULL;
  if (pd_tpu_model_load(argv[1], &model) != PD_TPU_OK) return 1;

  pthread_t threads[NUM_THREAD];
  worker_arg args[NUM_THREAD];
  for (int t = 0; t < NUM_THREAD; ++t) {
    args[t].model = model;           /* ONE model shared by all threads */
    args[t].feat = atol(argv[2]);
    args[t].tid = t;
    args[t].ok = 0;
    args[t].first_prob = 0.f;
    pthread_create(&threads[t], NULL, worker, &args[t]);
  }
  int all_ok = 1;
  for (int t = 0; t < NUM_THREAD; ++t) {
    pthread_join(threads[t], NULL);
    if (!args[t].ok) all_ok = 0;
    if (args[t].ok) {
      printf("thread %d: ok=1 probs[0]=%.6f\n", t, args[t].first_prob);
    } else {
      printf("thread %d: ok=0\n", t);
    }
  }

  pd_tpu_model_destroy(model);
  pd_tpu_shutdown();
  if (!all_ok) return 1;
  printf("MULTI_THREAD_INFER_OK\n");
  return 0;
}
