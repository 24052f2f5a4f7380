// Native 2-bit DNA packer for the host->device transfer path (ops/packed.py).
//
// One streaming pass packs 4 bases/byte and counts non-ACGT exceptions per
// row; an optional second pass (only over rows that have exceptions) fills
// the per-row exception lists, in place of the NumPy packer's several
// passes over the batch.
//
// Reference context: the reference ships raw ASCII bytes to the device
// (smith_waterman/src/aligner.rs:478-499); packing is a new-framework
// optimization, so there is no reference analogue to mirror.

#include <cstdint>

namespace {

struct Tables {
    uint8_t code[256];
    uint8_t bad[256];
    Tables() {
        for (int i = 0; i < 256; ++i) { code[i] = 0; bad[i] = 1; }
        const char* acgt = "ACGT";
        for (int i = 0; i < 4; ++i) {
            code[(uint8_t)acgt[i]] = (uint8_t)i;
            bad[(uint8_t)acgt[i]] = 0;
        }
    }
};
const Tables T;

}  // namespace

extern "C" {

// Pack arr (B x L row-major, L % 4 == 0) into packed (B x L/4); count
// exceptions (non-ACGT bytes at positions < lens[i]) into exc_counts (B).
// Bytes at positions >= lens[i] are pad: packed as code 0, never exceptions.
// Returns the max per-row exception count.
int64_t p2_pack(const uint8_t* arr, const int32_t* lens, int64_t B, int64_t L,
                uint8_t* packed, int32_t* exc_counts) {
    const int64_t L4 = L / 4;
    int64_t max_exc = 0;
    for (int64_t i = 0; i < B; ++i) {
        const uint8_t* row = arr + i * L;
        uint8_t* out = packed + i * L4;
        const int64_t len = lens[i];
        int64_t bad = 0;
        for (int64_t j = 0; j < L4; ++j) {
            const uint8_t* p = row + j * 4;
            out[j] = (uint8_t)(T.code[p[0]] | (T.code[p[1]] << 2) |
                               (T.code[p[2]] << 4) | (T.code[p[3]] << 6));
        }
        // exception count over the valid prefix only
        for (int64_t j = 0; j < len; ++j) bad += T.bad[row[j]];
        exc_counts[i] = (int32_t)bad;
        if (bad > max_exc) max_exc = bad;
    }
    return max_exc;
}

// Fill exc_col (B x K int32, pre-filled with L by the caller) and exc_val
// (B x K uint8) for rows whose exc_counts[i] > 0.
void p2_fill_exceptions(const uint8_t* arr, const int32_t* lens,
                        const int32_t* exc_counts, int64_t B, int64_t L,
                        int64_t K, int32_t* exc_col, uint8_t* exc_val) {
    for (int64_t i = 0; i < B; ++i) {
        if (exc_counts[i] == 0) continue;
        const uint8_t* row = arr + i * L;
        int32_t* col = exc_col + i * K;
        uint8_t* val = exc_val + i * K;
        const int64_t len = lens[i];
        int64_t k = 0;
        for (int64_t j = 0; j < len && k < K; ++j) {
            if (T.bad[row[j]]) {
                col[k] = (int32_t)j;
                val[k] = row[j];
                ++k;
            }
        }
    }
}

}  // extern "C"
