// Native CSV scenario loader for rscm_tpu.
//
// The counterpart of the reference's data-ingestion path (its regression
// and config layers read scenario CSVs through pandas).  Big scenario
// ensembles (thousands of SSP variants) make CSV parsing a measurable
// build-time cost, so the hot parse loop is native; a pure-Python csv
// fallback with identical semantics lives in rscm_tpu/native/csv.py.
//
// Format handled (the framework's scenario format, docs/tutorials/06):
//   header row:  time,Var A,Var B,...
//   data rows:   float,float,...          (strict: every cell numeric)
// Quoting/escapes are NOT handled (scenario files are plain numeric
// tables); the Python fallback is used for anything fancier.
//
// C ABI:
//   rscm_csv_dims(path, &rows, &cols)        -> 0 ok / negative errno-ish
//   rscm_csv_read(path, out, rows*cols)      -> 0 ok; out is row-major
// Header text is parsed on the Python side (one readline), so the ABI
// stays allocation-free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int64_t ERR_OPEN = -1;
constexpr int64_t ERR_FORMAT = -2;
constexpr int64_t ERR_OVERFLOW = -3;

// Count data rows and columns; returns 0 on success.
int64_t scan_dims(const char* path, int64_t* rows, int64_t* cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return ERR_OPEN;

    int64_t n_rows = 0, n_cols = 0;
    int64_t line_cols = 1;
    bool in_header = true, line_started = false;
    int c;
    while ((c = std::fgetc(f)) != EOF) {
        if (c == '\n') {
            if (line_started) {
                if (in_header) {
                    n_cols = line_cols;
                    in_header = false;
                } else {
                    if (line_cols != n_cols) { std::fclose(f); return ERR_FORMAT; }
                    n_rows++;
                }
            }
            line_cols = 1;
            line_started = false;
        } else if (c == ',') {
            line_cols++;
            line_started = true;
        } else if (c != '\r') {
            line_started = true;
        }
    }
    if (line_started) {  // final line without trailing newline
        if (in_header) {
            n_cols = line_cols;
        } else {
            if (line_cols != n_cols) { std::fclose(f); return ERR_FORMAT; }
            n_rows++;
        }
    }
    std::fclose(f);
    if (n_cols == 0) return ERR_FORMAT;
    *rows = n_rows;
    *cols = n_cols;
    return 0;
}

}  // namespace

extern "C" {

int64_t rscm_csv_dims(const char* path, int64_t* rows, int64_t* cols) {
    return scan_dims(path, rows, cols);
}

// Parse all data rows (after the header line) into `out`, row-major,
// capacity `capacity` doubles.  Returns number of values written, or a
// negative error.
int64_t rscm_csv_read(const char* path, double* out, int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return ERR_OPEN;

    // skip header line
    int c;
    while ((c = std::fgetc(f)) != EOF && c != '\n') {
    }

    int64_t written = 0;
    char buf[64];
    size_t blen = 0;
    bool any_in_line = false;
    // Whitespace handling matches the Python fallback's float(cell):
    // leading/trailing spaces are stripped, but a space *inside* the
    // numeric content (e.g. "1 2") is a format error, never silently
    // joined into "12".
    bool trailing_ws = false;

    auto flush_cell = [&]() -> int64_t {
        if (blen == 0) return ERR_FORMAT;  // empty cell
        buf[blen] = '\0';
        char* end = nullptr;
        double v = std::strtod(buf, &end);
        if (end == buf || *end != '\0') return ERR_FORMAT;  // non-numeric
        if (written >= capacity) return ERR_OVERFLOW;
        out[written++] = v;
        blen = 0;
        trailing_ws = false;
        return 0;
    };

    while ((c = std::fgetc(f)) != EOF) {
        if (c == ',' || c == '\n') {
            if (c == ',' || any_in_line || blen > 0) {
                int64_t rc = flush_cell();
                if (rc != 0) { std::fclose(f); return rc; }
            }
            trailing_ws = false;
            any_in_line = (c == ',');
        } else if (c == ' ' || c == '\t') {
            if (blen > 0) trailing_ws = true;  // only an error if content follows
        } else if (c != '\r') {
            if (trailing_ws) { std::fclose(f); return ERR_FORMAT; }  // interior space
            if (blen + 1 >= sizeof(buf)) { std::fclose(f); return ERR_FORMAT; }
            buf[blen++] = static_cast<char>(c);
            any_in_line = true;
        }
    }
    if (blen > 0) {
        int64_t rc = flush_cell();
        if (rc != 0) { std::fclose(f); return rc; }
    }
    std::fclose(f);
    return written;
}

}  // extern "C"
