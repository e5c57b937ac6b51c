/* Sequence-model C inference example, after Paddle's
 * capi/examples/model_inference/sequence/main.c: load a trained sequence
 * model (a paddle_tpu_torch.fluid.aot artifact with one lod_level=1 int64
 * feed), feed a batch of ragged integer token sequences, print the
 * per-sequence class probabilities.
 *
 * Usage: seq_infer <artifact_dir>
 */

#include <stdio.h>
#include <stdlib.h>

#include "../../../paddle_tpu_capi.h"

#define CHECK(stmt)                                        \
  do {                                                     \
    pd_tpu_error e = (stmt);                               \
    if (e != PD_TPU_OK) {                                  \
      fprintf(stderr, "FAIL %s -> %d\n", #stmt, (int)e);   \
      return 1;                                            \
    }                                                      \
  } while (0)

int main(int argc, char* argv[]) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <artifact_dir>\n", argv[0]);
    return 2;
  }

  CHECK(pd_tpu_init());
  pd_tpu_model model = NULL;
  CHECK(pd_tpu_model_load(argv[1], &model));

  /* three ragged sequences, concatenated (Paddle's example feeds a
   * word-id ivector with sequence start positions) */
  int64_t ids[] = {1, 2, 3, 4, /**/ 5, 6, /**/ 7, 8, 9};
  int64_t lens[] = {4, 2, 3};

  float output[256];
  int64_t rows = 0, cols = 0;
  CHECK(pd_tpu_model_run_seq(model, ids, lens, 3, output, 256, &rows,
                             &cols));

  printf("prob: %lld x %lld\n", (long long)rows, (long long)cols);
  for (int64_t i = 0; i < rows; ++i) {
    float sum = 0.f;
    printf("seq %lld:", (long long)i);
    for (int64_t j = 0; j < cols; ++j) {
      printf(" %.6f", output[i * cols + j]);
      sum += output[i * cols + j];
    }
    printf("  (sum %.6f)\n", sum);
  }

  CHECK(pd_tpu_model_destroy(model));
  CHECK(pd_tpu_shutdown());
  printf("SEQ_INFER_OK\n");
  return 0;
}
