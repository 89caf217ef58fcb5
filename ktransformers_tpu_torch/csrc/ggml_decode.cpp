// Native GGUF block decoders + int4 repacking (host data path): the
// PyTorch port's own copy of the JAX package's csrc/ggml_decode.cpp.
//
// Role-equivalent to the reference's C++ dequant/repack machinery
// (kt-kernel/operators/llamafile ggml paths, amx_quantization.hpp repack,
// cuda/custom_gguf/dequant.cu): loading a multi-hundred-GB GGUF through
// pure numpy is CPU-bound, so the block decoders and the packed-int4
// conversion run natively with OpenMP. Bound via ctypes
// (loader/native.py); the numpy implementations remain the reference/
// fallback and the two are cross-checked in tests/test_torch_gguf.py.
//
// Build: g++ at first use, by ktransformers_tpu_torch/loader/native.py
// (into ktransformers_tpu_torch/csrc/build/libggml_decode.so).

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            // subnormal
            exp = 127 - 15 + 1;
            while ((man & 0x400) == 0) {
                man <<= 1;
                exp--;
            }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

inline float load_f16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return f16_to_f32(v);
}

// Q4_K/Q5_K 6-bit scale/min unpack (get_scale_min_k4 layout).
inline void scale_min_k4(const uint8_t* s, int j, uint8_t* sc, uint8_t* m) {
    if (j < 4) {
        *sc = s[j] & 63;
        *m = s[j + 4] & 63;
    } else {
        *sc = (s[j + 4] & 0xF) | ((s[j - 4] >> 6) << 4);
        *m = (s[j + 4] >> 4) | ((s[j] >> 6) << 4);
    }
}

}  // namespace

extern "C" {

// ---- block decoders: raw [n_blocks * block_bytes] -> out [n_blocks * 256/32]

void decode_q8_0(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 34;
        float d = load_f16(b);
        const int8_t* q = (const int8_t*)(b + 2);
        float* o = out + i * 32;
        for (int j = 0; j < 32; ++j) o[j] = d * q[j];
    }
}

void decode_q4_0(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 18;
        float d = load_f16(b);
        const uint8_t* q = b + 2;
        float* o = out + i * 32;
        for (int j = 0; j < 16; ++j) {
            o[j] = d * (int)((q[j] & 0xF) - 8);
            o[j + 16] = d * (int)((q[j] >> 4) - 8);
        }
    }
}

void decode_q4_k(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 144;
        float d = load_f16(b);
        float dmin = load_f16(b + 2);
        const uint8_t* scales = b + 4;
        const uint8_t* qs = b + 16;
        float* o = out + i * 256;
        for (int chunk = 0; chunk < 4; ++chunk) {
            uint8_t sc1, m1, sc2, m2;
            scale_min_k4(scales, 2 * chunk, &sc1, &m1);
            scale_min_k4(scales, 2 * chunk + 1, &sc2, &m2);
            const uint8_t* q = qs + 32 * chunk;
            float* o1 = o + 64 * chunk;
            float* o2 = o1 + 32;
            for (int l = 0; l < 32; ++l) {
                o1[l] = d * sc1 * (q[l] & 0xF) - dmin * m1;
                o2[l] = d * sc2 * (q[l] >> 4) - dmin * m2;
            }
        }
    }
}

void decode_q5_k(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 176;
        float d = load_f16(b);
        float dmin = load_f16(b + 2);
        const uint8_t* scales = b + 4;
        const uint8_t* qh = b + 16;
        const uint8_t* qs = b + 48;
        float* o = out + i * 256;
        for (int chunk = 0; chunk < 4; ++chunk) {
            uint8_t sc1, m1, sc2, m2;
            scale_min_k4(scales, 2 * chunk, &sc1, &m1);
            scale_min_k4(scales, 2 * chunk + 1, &sc2, &m2);
            const uint8_t* q = qs + 32 * chunk;
            uint8_t u1 = 1u << (2 * chunk), u2 = 1u << (2 * chunk + 1);
            float* o1 = o + 64 * chunk;
            float* o2 = o1 + 32;
            for (int l = 0; l < 32; ++l) {
                int v1 = (q[l] & 0xF) + ((qh[l] & u1) ? 16 : 0);
                int v2 = (q[l] >> 4) + ((qh[l] & u2) ? 16 : 0);
                o1[l] = d * sc1 * v1 - dmin * m1;
                o2[l] = d * sc2 * v2 - dmin * m2;
            }
        }
    }
}

void decode_q6_k(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 210;
        const uint8_t* ql = b;
        const uint8_t* qh = b + 128;
        const int8_t* sc = (const int8_t*)(b + 192);
        float d = load_f16(b + 208);
        float* o = out + i * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* l_ = ql + 64 * half;
            const uint8_t* h_ = qh + 32 * half;
            float* oo = o + 128 * half;
            for (int l = 0; l < 32; ++l) {
                int q1 = (int)((l_[l] & 0xF) | (((h_[l] >> 0) & 3) << 4)) - 32;
                int q2 = (int)((l_[l + 32] & 0xF) | (((h_[l] >> 2) & 3) << 4)) - 32;
                int q3 = (int)((l_[l] >> 4) | (((h_[l] >> 4) & 3) << 4)) - 32;
                int q4 = (int)((l_[l + 32] >> 4) | (((h_[l] >> 6) & 3) << 4)) - 32;
                int is = 8 * half + l / 16;
                oo[l] = d * sc[is] * q1;
                oo[l + 32] = d * sc[is + 2] * q2;
                oo[l + 64] = d * sc[is + 4] * q3;
                oo[l + 96] = d * sc[is + 6] * q4;
            }
        }
    }
}

void decode_q2_k(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 84;
        const uint8_t* scales = b;
        const uint8_t* qs = b + 16;
        float d = load_f16(b + 80);
        float dmin = load_f16(b + 82);
        float* o = out + i * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* q = qs + 32 * half;
            for (int j = 0; j < 4; ++j) {
                for (int l = 0; l < 32; ++l) {
                    int e = 128 * half + 32 * j + l;
                    int idx = e / 16;
                    int v = (q[l] >> (2 * j)) & 3;
                    o[e] = d * (scales[idx] & 0xF) * v -
                           dmin * (scales[idx] >> 4);
                }
            }
        }
    }
}

void decode_q3_k(const uint8_t* raw, float* out, int64_t n_blocks) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_blocks; ++i) {
        const uint8_t* b = raw + i * 110;
        const uint8_t* hmask = b;
        const uint8_t* qs = b + 32;
        const uint8_t* s = b + 96;
        float d = load_f16(b + 108);
        int8_t sc[16];
        for (int j = 0; j < 8; ++j) {
            sc[j] = s[j] & 0xF;
            sc[j + 8] = s[j] >> 4;
        }
        for (int j = 0; j < 16; ++j) {
            sc[j] |= ((s[8 + (j % 4)] >> (2 * (j / 4))) & 3) << 4;
            sc[j] -= 32;
        }
        float* o = out + i * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* q = qs + 32 * half;
            for (int j = 0; j < 4; ++j) {
                uint8_t m = 1u << (4 * half + j);
                for (int l = 0; l < 32; ++l) {
                    int e = 128 * half + 32 * j + l;
                    int v = (q[l] >> (2 * j)) & 3;
                    if (!(hmask[l] & m)) v -= 4;
                    o[e] = d * sc[e / 16] * v;
                }
            }
        }
    }
}

// ---- repack: float [K, N] -> group-split nibble-packed int4 + scales
// (quant/formats.py pack_int4 convention: within each gs-row scale group,
// low nibble = first half rows, high nibble = second half).

void pack_int4_group_split(const float* w, int64_t K, int64_t N, int64_t gs,
                           uint8_t* packed, float* scales) {
    int64_t n_groups = K / gs;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t g = 0; g < n_groups; ++g) {
        for (int64_t n = 0; n < N; ++n) {
            float amax = 1e-10f;
            for (int64_t r = 0; r < gs; ++r) {
                float v = std::fabs(w[(g * gs + r) * N + n]);
                if (v > amax) amax = v;
            }
            float scale = amax / 7.0f;
            scales[g * N + n] = scale;
            float inv = 1.0f / scale;
            for (int64_t r = 0; r < gs / 2; ++r) {
                float lo_f = w[(g * gs + r) * N + n] * inv;
                float hi_f = w[(g * gs + gs / 2 + r) * N + n] * inv;
                int lo = (int)std::nearbyint(lo_f);
                int hi = (int)std::nearbyint(hi_f);
                lo = lo < -7 ? -7 : (lo > 7 ? 7 : lo);
                hi = hi < -7 ? -7 : (hi > 7 ? 7 : hi);
                packed[(g * gs / 2 + r) * N + n] =
                    (uint8_t)((lo & 0xF) | ((hi & 0xF) << 4));
            }
        }
    }
}

int native_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
