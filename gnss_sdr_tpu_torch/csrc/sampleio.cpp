// sampleio: native sample-format decoding for the GNSS receiver (a copy of
// native/sampleio.cpp, built by gnss_sdr_tpu_torch/io/native.py).
//
// Role: the host-side ingest hot path — the equivalent of the reference's
// data-type adapters and packed-format unpackers
// (src/algorithms/data_type_adapter/*, signal_source/gnuradio_blocks/
// unpack_2bit_samples.cc, unpack_byte_2bit_cpx_samples.cc), which are C++
// GNU Radio kernels there. Converts raw capture formats to interleaved
// float32 I/Q (complex64) buffers ready for device upload, plus a streaming
// file reader with its own buffer management.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// interleaved int16 I/Q -> float32 I/Q
void decode_ishort(const int16_t* in, int64_t n_samples, float* out) {
    for (int64_t i = 0; i < 2 * n_samples; ++i) {
        out[i] = static_cast<float>(in[i]);
    }
}

// interleaved int8 I/Q -> float32 I/Q
void decode_ibyte(const int8_t* in, int64_t n_samples, float* out) {
    for (int64_t i = 0; i < 2 * n_samples; ++i) {
        out[i] = static_cast<float>(in[i]);
    }
}

// real int16 -> complex (Q=0)
void decode_short(const int16_t* in, int64_t n_samples, float* out) {
    for (int64_t i = 0; i < n_samples; ++i) {
        out[2 * i] = static_cast<float>(in[i]);
        out[2 * i + 1] = 0.0f;
    }
}

// 2-bit sign/magnitude packed real samples, 4 per byte, LSB-first
// (reference: unpack_2bit_samples for the NSL/2-bit formats).
// map: 00->+1, 01->+3, 10->-1, 11->-3
void decode_2bit_packed_real(const uint8_t* in, int64_t n_bytes, float* out) {
    static const float lut[4] = {1.0f, 3.0f, -1.0f, -3.0f};
    for (int64_t i = 0; i < n_bytes; ++i) {
        uint8_t b = in[i];
        for (int k = 0; k < 4; ++k) {
            out[2 * (4 * i + k)] = lut[(b >> (2 * k)) & 3];
            out[2 * (4 * i + k) + 1] = 0.0f;
        }
    }
}

// LabSat 2/3 sample words (reference labsat23_source.cc
// decode_samples_one_channel): 16-bit words, MSB-first bit order.
// 2-bit mode: 8 complex samples/word, bit(15-2i)=I sign, bit(14-2i)=Q sign,
// value = 2*bit - 1 (so {0,1} -> {-1,+1}).
void decode_labsat_2bit(const uint16_t* in, int64_t n_words, float* out) {
    for (int64_t w = 0; w < n_words; ++w) {
        uint16_t v = in[w];
        for (int i = 0; i < 8; ++i) {
            int ib = (v >> (15 - 2 * i)) & 1;
            int qb = (v >> (14 - 2 * i)) & 1;
            out[2 * (8 * w + i)] = 2.0f * ib - 1.0f;
            out[2 * (8 * w + i) + 1] = 2.0f * qb - 1.0f;
        }
    }
}

// 4-bit mode: 4 complex samples/word, sign/magnitude per component:
// I: sign bit(15-4i), mag bit(13-4i); Q: sign bit(14-4i), mag bit(12-4i);
// map 00->+1, 01->+2, 10->-2, 11->-1.
void decode_labsat_4bit(const uint16_t* in, int64_t n_words, float* out) {
    static const float lut[4] = {1.0f, 2.0f, -2.0f, -1.0f};
    for (int64_t w = 0; w < n_words; ++w) {
        uint16_t v = in[w];
        for (int i = 0; i < 4; ++i) {
            int icode = (((v >> (15 - 4 * i)) & 1) << 1)
                      | ((v >> (13 - 4 * i)) & 1);
            int qcode = (((v >> (14 - 4 * i)) & 1) << 1)
                      | ((v >> (12 - 4 * i)) & 1);
            out[2 * (4 * w + i)] = lut[icode];
            out[2 * (4 * w + i) + 1] = lut[qcode];
        }
    }
}

// 2-bit complex packed: one byte = I(2b) Q(2b) I(2b) Q(2b) -> 2 complex
void decode_2bit_packed_cpx(const uint8_t* in, int64_t n_bytes, float* out) {
    static const float lut[4] = {1.0f, 3.0f, -1.0f, -3.0f};
    for (int64_t i = 0; i < n_bytes; ++i) {
        uint8_t b = in[i];
        out[4 * i + 0] = lut[b & 3];
        out[4 * i + 1] = lut[(b >> 2) & 3];
        out[4 * i + 2] = lut[(b >> 4) & 3];
        out[4 * i + 3] = lut[(b >> 6) & 3];
    }
}

// ---------------------------------------------------------------------
// Streaming file reader with internal buffer (double-buffer friendly):
// the reference's File_Signal_Source + adapter chain rolled into one.
// ---------------------------------------------------------------------

struct SampleReader {
    FILE* f;
    int item_kind;        // 0 ishort, 1 ibyte, 2 gr_complex, 3 short, 4 b2_real, 5 b2_cpx
    int64_t total_read;   // complex samples delivered
    uint8_t* raw;
    int64_t raw_cap;
};

void* reader_open(const char* path, int item_kind) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    SampleReader* r = new SampleReader();
    r->f = f;
    r->item_kind = item_kind;
    r->total_read = 0;
    r->raw_cap = 0;
    r->raw = nullptr;
    return r;
}

// Read up to n complex samples into out (float32 I/Q pairs).
// Returns the number of complex samples produced.
int64_t reader_read(void* handle, int64_t n, float* out) {
    SampleReader* r = static_cast<SampleReader*>(handle);
    int64_t bytes_per_n;
    switch (r->item_kind) {
        case 0: bytes_per_n = 4 * n; break;        // ishort
        case 1: bytes_per_n = 2 * n; break;        // ibyte
        case 2: bytes_per_n = 8 * n; break;        // gr_complex
        case 3: bytes_per_n = 2 * n; break;        // short (real)
        case 4: bytes_per_n = (n + 3) / 4; break;  // 2-bit real
        case 5: bytes_per_n = (n + 1) / 2; break;  // 2-bit cpx
        default: return 0;
    }
    if (bytes_per_n > r->raw_cap) {
        free(r->raw);
        r->raw = static_cast<uint8_t*>(malloc(bytes_per_n));
        r->raw_cap = bytes_per_n;
    }
    int64_t got = static_cast<int64_t>(fread(r->raw, 1, bytes_per_n, r->f));
    int64_t n_out = 0;
    switch (r->item_kind) {
        case 0:
            n_out = got / 4;
            decode_ishort(reinterpret_cast<int16_t*>(r->raw), n_out, out);
            break;
        case 1:
            n_out = got / 2;
            decode_ibyte(reinterpret_cast<int8_t*>(r->raw), n_out, out);
            break;
        case 2:
            n_out = got / 8;
            memcpy(out, r->raw, n_out * 8);
            break;
        case 3:
            n_out = got / 2;
            decode_short(reinterpret_cast<int16_t*>(r->raw), n_out, out);
            break;
        case 4:
            n_out = got * 4;
            decode_2bit_packed_real(r->raw, got, out);
            break;
        case 5:
            n_out = got * 2;
            decode_2bit_packed_cpx(r->raw, got, out);
            break;
    }
    r->total_read += n_out;
    return n_out;
}

void reader_seek(void* handle, int64_t complex_sample) {
    SampleReader* r = static_cast<SampleReader*>(handle);
    int64_t byte_off;
    switch (r->item_kind) {
        case 0: byte_off = 4 * complex_sample; break;
        case 1: byte_off = 2 * complex_sample; break;
        case 2: byte_off = 8 * complex_sample; break;
        case 3: byte_off = 2 * complex_sample; break;
        case 4: byte_off = complex_sample / 4; break;
        case 5: byte_off = complex_sample / 2; break;
        default: return;
    }
    fseeko(r->f, byte_off, SEEK_SET);
}

void reader_close(void* handle) {
    SampleReader* r = static_cast<SampleReader*>(handle);
    if (r->f) fclose(r->f);
    free(r->raw);
    delete r;
}

}  // extern "C"
