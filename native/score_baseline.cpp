// Single-core C++ candidate scorer — the benchmark baseline.
//
// What a well-written single-threaded C++ implementation of the
// reference's candidate evaluation would do: for each integer
// candidate x, one dense pass over the *unpadded* unified row matrix
// H accumulating hinge(Hx - ub) + hinge(lb - Hx)  (residual rows have
// lb == ub, hard rows are prescaled). -O2 -march=native
// auto-vectorized. bench.py's device candidates-scored/s is measured
// against this.
//
// Protocol: raw little-endian file
//   int32 Rows, V, B, iters
//   float32 H[Rows*V], lb[Rows], ub[Rows], X[B*V]
// prints "<candidates_per_sec> <checksum>".

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char **argv) {
    if (argc < 2) {
        std::fprintf(stderr, "usage: %s <data.bin>\n", argv[0]);
        return 1;
    }
    std::FILE *f = std::fopen(argv[1], "rb");
    if (!f) {
        std::perror("open");
        return 1;
    }
    int32_t hdr[4];
    if (std::fread(hdr, sizeof(int32_t), 4, f) != 4) return 1;
    const int Rows = hdr[0], V = hdr[1], B = hdr[2], iters = hdr[3];
    std::vector<float> H((size_t)Rows * V), lb(Rows), ub(Rows), X((size_t)B * V);
    auto rd = [&](std::vector<float> &v) {
        return std::fread(v.data(), sizeof(float), v.size(), f) == v.size();
    };
    if (!rd(H) || !rd(lb) || !rd(ub) || !rd(X)) return 1;
    std::fclose(f);

    double checksum = 0.0;
    auto t0 = std::chrono::steady_clock::now();
    for (int it = 0; it < iters; ++it) {
        for (int b = 0; b < B; ++b) {
            float *x = &X[(size_t)b * V];
            float score = 0.0f;
            for (int r = 0; r < Rows; ++r) {
                const float *h = &H[(size_t)r * V];
                float acc = 0.0f;
                for (int v = 0; v < V; ++v) acc += h[v] * x[v];
                if (acc > ub[r]) score += acc - ub[r];
                if (acc < lb[r]) score += lb[r] - acc;
            }
            checksum += score;
            // data-dependent mutation mirroring the device benchmark's
            // chained update (prevents dead-code elimination)
            x[(b + it) % V] = (float)((int)(x[(b + it) % V] + score) % 3);
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs =
        std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
        1e9;
    double cps = (double)B * iters / secs;
    std::printf("%.1f %.3f\n", cps, checksum);
    return 0;
}
