/* Native helpers for the host-side data path.
 *
 * The reference's host runtime is C++ (PCL io, rosbag decode); this is the
 * framework's native equivalent: LZF decompression for binary_compressed
 * PCD payloads (PCL's codec) and a fused binary-PCD field extractor, both
 * exposed through a plain C ABI for ctypes. ctypes releases the GIL during
 * calls, so Python threads over these functions decode in parallel (see
 * toyslam_tpu_torch/runtime/native.py).
 *
 * Reference behaviours covered: PCD scan dumps (lidar_subscriber_node.cpp:46),
 * directory ingestion (ndt_omp_node.cpp / ndt_omp_mapping_node.cpp:72-108).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* LZF decompression (format used by PCL binary_compressed PCDs). */
long lzf_decompress(const uint8_t *in, long in_len,
                    uint8_t *out, long out_len) {
    const uint8_t *ip = in;
    const uint8_t *in_end = in + in_len;
    uint8_t *op = out;
    uint8_t *out_end = out + out_len;

    while (ip < in_end) {
        unsigned int ctrl = *ip++;
        if (ctrl < 32) { /* literal run */
            unsigned int len = ctrl + 1;
            if (op + len > out_end || ip + len > in_end) return -1;
            memcpy(op, ip, len);
            op += len;
            ip += len;
        } else { /* back reference */
            unsigned int len = ctrl >> 5;
            if (len == 7) {
                if (ip >= in_end) return -1;
                len += *ip++;
            }
            if (ip >= in_end) return -1;
            uint8_t *ref = op - ((ctrl & 0x1f) << 8) - *ip++ - 1;
            if (ref < out || op + len + 2 > out_end) return -1;
            len += 2;
            while (len--) *op++ = *ref++;
        }
    }
    return (long)(op - out);
}

/* Extract x, y, z (+ optional intensity) columns from interleaved binary
 * point records into a packed [n, 4] float32 array.
 *
 * record_size: bytes per point; offsets: byte offsets of x, y, z, intensity
 * within a record (intensity_offset < 0 -> fill 0). Returns n. */
long extract_xyzi(const uint8_t *data, long n_points, long record_size,
                  long x_off, long y_off, long z_off, long i_off,
                  float *out /* [n_points * 4] */) {
    for (long i = 0; i < n_points; ++i) {
        const uint8_t *rec = data + i * record_size;
        float x, y, z, inten = 0.0f;
        memcpy(&x, rec + x_off, 4);
        memcpy(&y, rec + y_off, 4);
        memcpy(&z, rec + z_off, 4);
        if (i_off >= 0) memcpy(&inten, rec + i_off, 4);
        out[i * 4 + 0] = x;
        out[i * 4 + 1] = y;
        out[i * 4 + 2] = z;
        out[i * 4 + 3] = inten;
    }
    return n_points;
}

/* Same for field-major (SoA) payloads produced by binary_compressed PCDs:
 * columns at the given byte offsets into the decompressed buffer. */
long extract_xyzi_soa(const uint8_t *data, long n_points,
                      long x_off, long y_off, long z_off, long i_off,
                      float *out) {
    const float *xs = (const float *)(data + x_off);
    const float *ys = (const float *)(data + y_off);
    const float *zs = (const float *)(data + z_off);
    const float *is = i_off >= 0 ? (const float *)(data + i_off) : 0;
    for (long i = 0; i < n_points; ++i) {
        out[i * 4 + 0] = xs[i];
        out[i * 4 + 1] = ys[i];
        out[i * 4 + 2] = zs[i];
        out[i * 4 + 3] = is ? is[i] : 0.0f;
    }
    return n_points;
}
