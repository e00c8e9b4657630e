/* Native ROS1 bag (format 2.0) scan reader.
 *
 * The reference's headline mapping pipeline ingests scans natively via
 * rosbag::View + pcl::fromROSMsg (ndt_rosbag_mapping_node.cpp:27-78);
 * this is the framework's native equivalent: parse the bag record
 * stream (op 0x03 bag header, 0x07 connection, 0x05 chunk with
 * none/bz2/lz4 compression, 0x02 message data), decode
 * sensor_msgs/PointCloud2 payloads, and pack them straight into the
 * fixed-capacity [S, capacity, 4] float32 + [S, capacity] mask layout
 * the device pipelines consume (pad sentinel 1e9, intensity 0) — one
 * pass, no intermediate per-message Python objects.
 *
 * Exposed through a plain C ABI for ctypes (bag_pack_scans); the pure
 * Python reader of toyslam_tpu_torch/runtime/rosbag.py (native=False)
 * produces byte-identical output (differential-tested in
 * tests/test_torch_rosbag.py).
 *
 * bz2 chunks are decoded by libbz2, opened with dlopen at the first bz2
 * chunk. Where it cannot be opened, such a chunk fails with its own code
 * (-3), which the Python side raises as an error naming bz2.
 *
 * Every length/offset read from the file is bounds-validated before use;
 * malformed input returns an error code instead of reading out of
 * bounds.
 */

#include <dlfcn.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PAD_COORD 1.0e9f

/* The one libbz2 entry point used (the classic stable bzip2 ABI), looked
 * up once, at the first bz2 chunk, so that the library needs neither
 * bzip2's headers nor libbz2 at build time. */
typedef int (*Bz2Decompress)(char *dest, unsigned *dest_len, char *source,
                             unsigned source_len, int small, int verbosity);
static Bz2Decompress bz2_decompress;
static pthread_once_t bz2_once = PTHREAD_ONCE_INIT;

static void bz2_open(void) {
    const char *names[] = {"libbz2.so.1", "libbz2.so.1.0", "libbz2.so"};
    for (int i = 0; i < 3 && !bz2_decompress; ++i) {
        void *lib = dlopen(names[i], RTLD_NOW | RTLD_LOCAL);
        if (lib)
            bz2_decompress = (Bz2Decompress)dlsym(
                lib, "BZ2_bzBuffToBuffDecompress");
    }
}

/* 1 if bz2 chunks can be decoded, else 0. */
long host_bz2_available(void) {
    pthread_once(&bz2_once, bz2_open);
    return bz2_decompress != NULL;
}

static const char MAGIC[] = "#ROSBAG V2.0\n";

/* ------------------------------------------------------------------ */
/* LZ4 frame decode (rosbag's roslz4 chunk compression)                */
/* ------------------------------------------------------------------ */

static uint32_t rd_u32(const uint8_t *p);

/* xxHash32 — the checksum the LZ4 frame header carries. */
static uint32_t xxh32(const uint8_t *data, long len, uint32_t seed) {
    const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u;
    const uint32_t P4 = 668265263u, P5 = 374761393u;
    long i = 0;
    uint32_t h;
#define ROTL(x, r) (((x) << (r)) | ((x) >> (32 - (r))))
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2;
        uint32_t v3 = seed, v4 = seed - P1;
        while (i + 16 <= len) {
            v1 = ROTL(v1 + rd_u32(data + i) * P2, 13) * P1;
            v2 = ROTL(v2 + rd_u32(data + i + 4) * P2, 13) * P1;
            v3 = ROTL(v3 + rd_u32(data + i + 8) * P2, 13) * P1;
            v4 = ROTL(v4 + rd_u32(data + i + 12) * P2, 13) * P1;
            i += 16;
        }
        h = ROTL(v1, 1) + ROTL(v2, 7) + ROTL(v3, 12) + ROTL(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (i + 4 <= len) {
        h = ROTL(h + rd_u32(data + i) * P3, 17) * P4;
        i += 4;
    }
    while (i < len) {
        h = ROTL(h + data[i] * P5, 11) * P1;
        i += 1;
    }
    h ^= h >> 15;
    h *= P2;
    h ^= h >> 13;
    h *= P3;
    h ^= h >> 16;
    return h;
#undef ROTL
}

/* Decode one LZ4 block into dst at *dpos (matches may reference earlier
 * frame output, so the caller decodes all blocks of a frame into one
 * growing region). Returns 0 or -1 on malformed/overflowing input. */
static int lz4_block_decode(const uint8_t *src, long slen, uint8_t *dst,
                            long dcap, long *dpos) {
    long i = 0, o = *dpos;
    while (i < slen) {
        int token = src[i++];
        long lit = token >> 4;
        if (lit == 15) {
            int b;
            do {
                if (i >= slen) return -1;
                b = src[i++];
                lit += b;
            } while (b == 255);
        }
        if (i + lit > slen || o + lit > dcap) return -1;
        memcpy(dst + o, src + i, lit);
        i += lit;
        o += lit;
        if (i == slen) break; /* final sequence: literals only */
        if (i + 2 > slen) return -1;
        long offset = src[i] | ((long)src[i + 1] << 8);
        i += 2;
        if (offset == 0 || offset > o) return -1;
        long mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            int b;
            do {
                if (i >= slen) return -1;
                b = src[i++];
                mlen += b;
            } while (b == 255);
        }
        if (o + mlen > dcap) return -1;
        /* Overlapping matches repeat with period `offset`: byte copy. */
        for (long k = 0; k < mlen; ++k) dst[o + k] = dst[o + k - offset];
        o += mlen;
    }
    *dpos = o;
    return 0;
}

/* Decode all LZ4 frames in src into dst (capacity dcap). Mirrors
 * runtime/lz4f.py `decompress` exactly (header checksum verified,
 * block/content xxh32s skipped, skippable frames skipped). Returns the
 * decoded length, or -1 on malformed input / overflow. Exposed through
 * the ctypes ABI for the byte-identical differential test
 * (tests/test_lz4.py). */
long lz4f_decompress(const uint8_t *src, long slen, uint8_t *dst,
                     long dcap) {
    long pos = 0, out = 0;
    while (pos < slen) {
        if (pos + 4 > slen) return -1;
        uint32_t magic = rd_u32(src + pos);
        pos += 4;
        if (magic >= 0x184D2A50u && magic <= 0x184D2A5Fu) { /* skippable */
            if (pos + 4 > slen) return -1;
            uint32_t size = rd_u32(src + pos);
            pos += 4 + (long)size;
            if (pos > slen) return -1;
            continue;
        }
        if (magic != 0x184D2204u) return -1;
        if (pos + 2 > slen) return -1;
        long desc_start = pos;
        int flg = src[pos];
        pos += 2; /* FLG + BD */
        if ((flg >> 6) != 1) return -1; /* version */
        int b_checksum = (flg >> 4) & 1;
        if ((flg >> 3) & 1) pos += 8; /* content size */
        if (flg & 1) pos += 4;        /* dict id */
        if (pos + 1 > slen) return -1;
        uint8_t hc = src[pos];
        if (hc != ((xxh32(src + desc_start, pos - desc_start, 0) >> 8)
                   & 0xFF))
            return -1;
        pos += 1;
        for (;;) {
            if (pos + 4 > slen) return -1;
            uint32_t bsize = rd_u32(src + pos);
            pos += 4;
            if (bsize == 0) break; /* EndMark */
            int stored = (bsize >> 31) & 1;
            long blen = (long)(bsize & 0x7FFFFFFFu);
            if (pos + blen > slen) return -1;
            if (stored) {
                if (out + blen > dcap) return -1;
                memcpy(dst + out, src + pos, blen);
                out += blen;
            } else if (lz4_block_decode(src + pos, blen, dst, dcap,
                                        &out) != 0) {
                return -1;
            }
            pos += blen;
            if (b_checksum) pos += 4; /* block xxh32, skipped */
        }
        if ((flg >> 2) & 1) pos += 4; /* content xxh32, skipped */
    }
    return out;
}

/* ------------------------------------------------------------------ */
/* Record-header field scanning                                        */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *val;
    long len;
} Field;

static uint32_t rd_u32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

/* Find "key=" inside a record header blob. Returns 0 and fills f on a
 * hit, -1 when absent, -2 on malformed framing. */
static int find_field(const uint8_t *hdr, long hlen, const char *key,
                      Field *f) {
    long klen = (long)strlen(key);
    long pos = 0;
    while (pos + 4 <= hlen) {
        long flen = (long)rd_u32(hdr + pos);
        pos += 4;
        if (flen < 0 || pos + flen > hlen) return -2;
        const uint8_t *entry = hdr + pos;
        if (flen > klen && entry[klen] == '=' &&
            !memcmp(entry, key, klen)) {
            f->val = entry + klen + 1;
            f->len = flen - klen - 1;
            return 0;
        }
        pos += flen;
    }
    return -1;
}

/* One record: [hlen u32][header][dlen u32][data]. Returns 0 on success. */
static int read_record(const uint8_t *buf, long len, long *pos,
                       const uint8_t **hdr, long *hlen,
                       const uint8_t **data, long *dlen) {
    if (*pos + 4 > len) return -1;
    long h = (long)rd_u32(buf + *pos);
    if (h < 0 || *pos + 4 + h + 4 > len) return -1;
    *hdr = buf + *pos + 4;
    *hlen = h;
    long d = (long)rd_u32(buf + *pos + 4 + h);
    if (d < 0 || *pos + 4 + h + 4 + d > len) return -1;
    *data = buf + *pos + 4 + h + 4;
    *dlen = d;
    *pos += 4 + h + 4 + d;
    return 0;
}

/* ------------------------------------------------------------------ */
/* PointCloud2 decode                                                  */
/* ------------------------------------------------------------------ */

/* Decode one serialized sensor_msgs/PointCloud2 into a [capacity, 4]
 * xyzi slot + mask, mirroring runtime/rosbag.decode_pointcloud2 +
 * loader.pack_scan exactly. Returns valid point count written, or -1 on
 * malformed/unsupported payloads. */
static long decode_cloud(const uint8_t *raw, long len, long capacity,
                         float *out, uint8_t *mask) {
    long pos = 4 + 8; /* seq + stamp */
    if (pos + 4 > len) return -1;
    long flen = (long)rd_u32(raw + pos);
    pos += 4 + flen; /* frame_id */
    if (flen < 0 || pos + 8 + 4 > len) return -1;
    uint64_t height = rd_u32(raw + pos);
    uint64_t width = rd_u32(raw + pos + 4);
    pos += 8;
    long n_fields = (long)rd_u32(raw + pos);
    pos += 4;
    long off_x = -1, off_y = -1, off_z = -1, off_i = -1;
    if (n_fields < 0 || n_fields > 1024) return -1;
    for (long k = 0; k < n_fields; ++k) {
        if (pos + 4 > len) return -1;
        long nlen = (long)rd_u32(raw + pos);
        pos += 4;
        if (nlen < 0 || pos + nlen + 9 > len) return -1;
        const uint8_t *name = raw + pos;
        pos += nlen;
        long offset = (long)rd_u32(raw + pos);
        int datatype = raw[pos + 4];
        pos += 9; /* offset u32, datatype u8, count u32 */
        long *slot = NULL;
        if (nlen == 1 && name[0] == 'x') slot = &off_x;
        else if (nlen == 1 && name[0] == 'y') slot = &off_y;
        else if (nlen == 1 && name[0] == 'z') slot = &off_z;
        else if (nlen == 9 && !memcmp(name, "intensity", 9)) slot = &off_i;
        if (slot) {
            if (datatype != 7) return -1; /* only FLOAT32 */
            *slot = offset;
        }
    }
    if (pos + 1 + 4 + 4 + 4 > len) return -1;
    int is_bigendian = raw[pos];
    pos += 1;
    long point_step = (long)rd_u32(raw + pos);
    pos += 4;
    pos += 4; /* row_step */
    long dlen = (long)rd_u32(raw + pos);
    pos += 4;
    if (dlen < 0 || pos + dlen > len) return -1;
    const uint8_t *data = raw + pos;

    if (is_bigendian || off_x < 0 || off_y < 0 || off_z < 0) return -1;
    if (point_step < 4) return -1;
    long max_off = off_x > off_y ? off_x : off_y;
    if (off_z > max_off) max_off = off_z;
    if (off_i > max_off) max_off = off_i;
    if (max_off + 4 > point_step) return -1;

    /* Division-form bound: n * point_step can wrap int64 for crafted
     * height/width/point_step (e.g. n = 2^33, step = 2^31 wraps to 0),
     * which would pass a product check and send the decode loop far out
     * of bounds. point_step >= 4 was checked above. */
    long n = (long)(height * width);
    if (n < 0 || n > dlen / point_step) return -1;

    for (long i = 0; i < capacity; ++i) {
        out[i * 4 + 0] = PAD_COORD;
        out[i * 4 + 1] = PAD_COORD;
        out[i * 4 + 2] = PAD_COORD;
        out[i * 4 + 3] = 0.0f;
        mask[i] = 0;
    }
    long k = n < capacity ? n : capacity;
    for (long i = 0; i < k; ++i) {
        const uint8_t *rec = data + i * point_step;
        float x, y, z, inten = 0.0f;
        memcpy(&x, rec + off_x, 4);
        memcpy(&y, rec + off_y, 4);
        memcpy(&z, rec + off_z, 4);
        if (off_i >= 0) memcpy(&inten, rec + off_i, 4);
        out[i * 4 + 0] = x;
        out[i * 4 + 1] = y;
        out[i * 4 + 2] = z;
        out[i * 4 + 3] = inten;
        mask[i] = isfinite(x) && isfinite(y) && isfinite(z);
    }
    return k;
}

/* ------------------------------------------------------------------ */
/* Connection table (conn id -> matches requested topic)               */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *match; /* 0 unknown, 1 match, 2 no-match */
    long cap;
} Conns;

static int conns_note(Conns *c, long id, int match) {
    if (id < 0 || id > (1L << 20)) return -1;
    if (id >= c->cap) {
        long ncap = c->cap ? c->cap : 64;
        while (ncap <= id) ncap *= 2;
        uint8_t *nm = (uint8_t *)realloc(c->match, ncap);
        if (!nm) return -1;
        memset(nm + c->cap, 0, ncap - c->cap);
        c->match = nm;
        c->cap = ncap;
    }
    c->match[id] = (uint8_t)match;
    return 0;
}

/* Returns 0, or -1 when the connection table cannot record the id (id
 * out of the sane range or allocation failure) — callers treat that as
 * malformed input rather than silently dropping the topic's messages. */
static int handle_connection(Conns *conns, const uint8_t *hdr, long hlen,
                             const uint8_t *data, long dlen,
                             const char *topic) {
    Field fconn, ftopic, ftype;
    if (find_field(hdr, hlen, "conn", &fconn) != 0 || fconn.len != 4)
        return 0; /* not a well-formed connection record: ignore */
    long id = (long)rd_u32(fconn.val);
    int match = 2;
    if (find_field(hdr, hlen, "topic", &ftopic) == 0) {
        long tlen = (long)strlen(topic);
        if (ftopic.len == tlen && !memcmp(ftopic.val, topic, tlen)) {
            /* Topic matches; require the connection type to be
             * PointCloud2 (or unknown), like the Python reader. */
            match = 1;
            if (find_field(data, dlen, "type", &ftype) == 0 &&
                ftype.len > 0) {
                int has = 0;
                for (long i = 0; i + 11 <= ftype.len; ++i)
                    if (!memcmp(ftype.val + i, "PointCloud2", 11)) has = 1;
                if (!has) match = 2;
            }
        }
    }
    return conns_note(conns, id, match);
}

/* Process a flat record stream (a decompressed chunk payload or the
 * top level): connections update the table, matching message-data
 * records decode into the next output slot. Returns 0, or -1 on
 * malformed framing. */
static int handle_stream(const uint8_t *buf, long len, Conns *conns,
                         const char *topic, long max_scans, long capacity,
                         float *out_xyzi, uint8_t *out_mask, double *out_t,
                         long *out_npts, long *n_scans) {
    long pos = 0;
    while (pos < len) {
        const uint8_t *hdr, *data;
        long hlen, dlen;
        if (read_record(buf, len, &pos, &hdr, &hlen, &data, &dlen) != 0)
            return -1;
        Field fop;
        int frc = find_field(hdr, hlen, "op", &fop);
        if (frc == -2) return -1; /* malformed header framing */
        if (frc != 0 || fop.len < 1) continue;
        int op = fop.val[0];
        if (op == 0x07) {
            if (handle_connection(conns, hdr, hlen, data, dlen, topic) != 0)
                return -1;
        } else if (op == 0x02) {
            Field fconn, ftime;
            if (find_field(hdr, hlen, "conn", &fconn) != 0 ||
                fconn.len != 4)
                continue;
            long id = (long)rd_u32(fconn.val);
            if (id < 0 || id >= conns->cap || conns->match[id] != 1)
                continue;
            if (*n_scans >= max_scans) continue;
            long s = *n_scans;
            if (out_xyzi) { /* NULL = count-only pass: no decode */
                double t = 0.0;
                if (find_field(hdr, hlen, "time", &ftime) == 0 &&
                    ftime.len == 8) {
                    /* secs u32 LE then nsecs u32 LE */
                    t = (double)rd_u32(ftime.val) +
                        (double)rd_u32(ftime.val + 4) * 1e-9;
                }
                long npts = decode_cloud(
                    data, dlen, capacity,
                    out_xyzi + s * capacity * 4, out_mask + s * capacity);
                if (npts < 0) return -1;
                out_t[s] = t;
                out_npts[s] = npts;
            }
            *n_scans = s + 1;
        }
    }
    return 0;
}

/* Parse a whole in-memory ROS bag; pack every PointCloud2 on `topic`
 * into the [max_scans, capacity, 4] xyzi + [max_scans, capacity] mask +
 * [max_scans] time/count buffers. out_xyzi == NULL runs a count-only
 * pass (framing + connection filtering, no cloud decode; the other out
 * pointers are ignored) so the caller can size buffers in one native
 * pre-pass. Returns the number of scans packed (or counted), -1 on
 * malformed input, -2 on unsupported chunk compression, -3 on a bz2 chunk
 * when libbz2 could not be opened. */
long bag_pack_scans(const uint8_t *buf, long len, const char *topic,
                    long max_scans, long capacity, float *out_xyzi,
                    uint8_t *out_mask, double *out_t, long *out_npts) {
    long magic = (long)sizeof(MAGIC) - 1;
    if (len < magic || memcmp(buf, MAGIC, magic)) return -1;
    Conns conns = {NULL, 0};
    long n_scans = 0;
    long pos = magic;
    int rc = 0;
    while (pos < len && rc == 0) {
        const uint8_t *hdr, *data;
        long hlen, dlen;
        if (read_record(buf, len, &pos, &hdr, &hlen, &data, &dlen) != 0) {
            rc = -1;
            break;
        }
        Field fop;
        int frc = find_field(hdr, hlen, "op", &fop);
        if (frc == -2) { rc = -1; break; } /* malformed header framing */
        if (frc != 0 || fop.len < 1) continue;
        int op = fop.val[0];
        if (op == 0x05) { /* chunk */
            Field fcomp;
            int comp = 0; /* 0 none, 1 bz2, 2 lz4 */
            if (find_field(hdr, hlen, "compression", &fcomp) == 0) {
                if (fcomp.len == 3 && !memcmp(fcomp.val, "bz2", 3))
                    comp = 1;
                else if (fcomp.len == 3 && !memcmp(fcomp.val, "lz4", 3))
                    comp = 2;
                else if (!(fcomp.len == 4 &&
                           !memcmp(fcomp.val, "none", 4))) {
                    rc = -2;
                    break;
                }
            }
            if (comp) {
                Field fsize;
                if (find_field(hdr, hlen, "size", &fsize) != 0 ||
                    fsize.len != 4) {
                    rc = -1;
                    break;
                }
                unsigned usize = rd_u32(fsize.val);
                if (usize == 0 || usize > (1u << 30)) {
                    rc = -1;
                    break;
                }
                uint8_t *plain = (uint8_t *)malloc(usize);
                if (!plain) {
                    rc = -1;
                    break;
                }
                int ok;
                if (comp == 1 && !host_bz2_available()) {
                    free(plain);
                    rc = -3;
                    break;
                }
                if (comp == 1) {
                    unsigned got = usize;
                    ok = bz2_decompress(
                             (char *)plain, &got, (char *)data,
                             (unsigned)dlen, 0, 0) == 0 &&
                         got == usize;
                } else {
                    ok = lz4f_decompress(data, dlen, plain,
                                         (long)usize) == (long)usize;
                }
                if (!ok) {
                    free(plain);
                    rc = -1;
                    break;
                }
                rc = handle_stream(plain, (long)usize, &conns, topic,
                                   max_scans, capacity, out_xyzi,
                                   out_mask, out_t, out_npts, &n_scans);
                free(plain);
            } else {
                rc = handle_stream(data, dlen, &conns, topic, max_scans,
                                   capacity, out_xyzi, out_mask, out_t,
                                   out_npts, &n_scans);
            }
        } else if (op == 0x07) {
            if (handle_connection(&conns, hdr, hlen, data, dlen,
                                  topic) != 0) {
                rc = -1;
                break;
            }
        } else if (op == 0x02) {
            /* Stray message outside chunks (the Python reader skips
             * these too — connections may not be known yet). */
        }
    }
    free(conns.match);
    return rc == 0 ? n_scans : rc;
}
