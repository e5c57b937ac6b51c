/* Dense-model C inference example, after Paddle's
 * capi/examples/model_inference/dense/main.c: init the runtime, load a
 * trained model (a paddle_tpu_torch.fluid.aot artifact), run one forward
 * pass, print the per-class probabilities.
 *
 * Usage: dense_infer <artifact_dir> <feature_dim>
 * Build: see ../../../Makefile (cc main.c ../../../paddle_tpu_capi.c
 *        $(python3-config --includes) $(python3-config --embed --ldflags)).
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
  if (argc < 3) {
    fprintf(stderr, "usage: %s <artifact_dir> <feature_dim>\n", argv[0]);
    return 2;
  }
  const char* dir = argv[1];
  long feat = atol(argv[2]);

  CHECK(pd_tpu_init());

  pd_tpu_model model = NULL;
  CHECK(pd_tpu_model_load(dir, &model));

  float* input = (float*)malloc(sizeof(float) * feat);
  for (long i = 0; i < feat; ++i) {
    input[i] = (float)(i % 7) * 0.125f - 0.375f;
  }

  float output[256];
  int64_t rows = 0, cols = 0;
  CHECK(pd_tpu_model_run(model, input, 1, feat, output, 256, &rows, &cols));

  printf("prob: %lld x %lld\n", (long long)rows, (long long)cols);
  float sum = 0.f;
  for (int64_t j = 0; j < cols; ++j) {
    printf(" %.6f", output[j]);
    sum += output[j];
  }
  printf("\nsum: %.6f\n", sum);

  free(input);
  CHECK(pd_tpu_model_destroy(model));
  CHECK(pd_tpu_shutdown());
  printf("DENSE_INFER_OK\n");
  return 0;
}
