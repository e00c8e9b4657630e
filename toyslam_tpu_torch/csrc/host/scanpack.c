/* Threaded batch PCD scan packer.
 *
 * The reference ingests scan directories with C++ PCL readers inside ROS
 * nodes (ndt_omp_node.cpp / ndt_omp_mapping_node.cpp load_pointclouds);
 * this is the framework's native equivalent: a pthread pool that parses N
 * binary / binary_compressed / ascii PCD files and packs them straight
 * into the fixed-capacity [S, capacity, 4] float32 + [S, capacity] mask
 * layout the device pipelines consume (pad sentinel 1e9, intensity 0).
 *
 * Exposed through a plain C ABI for ctypes (pack_scans); the Python
 * route of toyslam_tpu_torch/runtime/loader.py (native=False) produces
 * byte-identical output (differential-tested in
 * tests/test_torch_runtime.py).
 *
 * The header parser runs in every worker at once, so it tokenises with
 * strtok_r and keeps its state on its own stack: strtok's one static
 * cursor, shared by the threads, made a call fail now and then when two
 * workers parsed headers at the same moment.
 */

#include <ctype.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define PAD_COORD 1.0e9f

extern long lzf_decompress(const uint8_t *in, long in_len,
                           uint8_t *out, long out_len);

typedef struct {
    long n_fields;
    long offsets[32];   /* byte offset of each field within a record */
    long sizes[32];
    char types[32];
    long record_size;
    long x, y, z, inten; /* field indices, -1 if absent */
    long n_points;
    int data_mode;       /* 0 ascii, 1 binary, 2 binary_compressed */
    long header_end;     /* byte offset of first payload byte */
} PcdHeader;

static int parse_header(const uint8_t *buf, long len, PcdHeader *h) {
    memset(h, 0, sizeof(*h));
    h->x = h->y = h->z = h->inten = -1;
    h->n_points = -1;
    long pos = 0;
    char line[1024];
    long counts[32];
    for (long i = 0; i < 32; ++i) counts[i] = 1;
    while (pos < len) {
        long e = pos;
        while (e < len && buf[e] != '\n') ++e;
        long n = e - pos;
        if (n >= (long)sizeof(line)) n = sizeof(line) - 1;
        memcpy(line, buf + pos, n);
        line[n] = 0;
        pos = e + 1;
        if (line[0] == '#') continue;
        char *save = NULL;
        if (!strncmp(line, "FIELDS", 6)) {
            char *tok = strtok_r(line + 6, " \r", &save);
            while (tok && h->n_fields < 32) {
                if (!strcmp(tok, "x")) h->x = h->n_fields;
                else if (!strcmp(tok, "y")) h->y = h->n_fields;
                else if (!strcmp(tok, "z")) h->z = h->n_fields;
                else if (!strcmp(tok, "intensity")) h->inten = h->n_fields;
                h->n_fields++;
                tok = strtok_r(NULL, " \r", &save);
            }
        } else if (!strncmp(line, "SIZE", 4)) {
            char *tok = strtok_r(line + 4, " \r", &save);
            long i = 0;
            while (tok && i < h->n_fields) {
                h->sizes[i++] = atol(tok);
                tok = strtok_r(NULL, " \r", &save);
            }
        } else if (!strncmp(line, "TYPE", 4)) {
            char *tok = strtok_r(line + 4, " \r", &save);
            long i = 0;
            while (tok && i < h->n_fields) {
                h->types[i++] = tok[0];
                tok = strtok_r(NULL, " \r", &save);
            }
        } else if (!strncmp(line, "COUNT", 5)) {
            char *tok = strtok_r(line + 5, " \r", &save);
            long i = 0;
            while (tok && i < h->n_fields) {
                counts[i++] = atol(tok);
                tok = strtok_r(NULL, " \r", &save);
            }
        } else if (!strncmp(line, "POINTS", 6)) {
            h->n_points = atol(line + 6);
        } else if (!strncmp(line, "WIDTH", 5)) {
            if (h->n_points < 0) h->n_points = atol(line + 5);
        } else if (!strncmp(line, "HEIGHT", 6)) {
            /* n_points from POINTS covers organized clouds */
        } else if (!strncmp(line, "DATA", 4)) {
            const char *m = line + 4;
            while (*m == ' ') ++m;
            if (!strncmp(m, "binary_compressed", 17)) h->data_mode = 2;
            else if (!strncmp(m, "binary", 6)) h->data_mode = 1;
            else h->data_mode = 0;
            h->header_end = pos;
            break;
        }
    }
    if (h->n_points < 0 || h->n_fields == 0 || h->header_end == 0)
        return -1;
    /* Hard bounds on everything atol() pulled from the header: sizes,
     * counts, and n_points multiply into offsets and payload extents
     * below — unbounded values wrap long and turn the bounds checks
     * into no-ops (OOB reads). 2^31 points x 2^20-byte records stays
     * far from the int64 edge. */
    if (h->n_points > (1L << 31)) return -1;
    long off = 0;
    for (long i = 0; i < h->n_fields; ++i) {
        if (h->sizes[i] < 1 || h->sizes[i] > 8) return -1;
        if (counts[i] < 1 || counts[i] > 1024) return -1;
        h->offsets[i] = off;
        off += h->sizes[i] * counts[i];
    }
    h->record_size = off;
    if (h->record_size > (1L << 20)) return -1;
    if (h->x < 0 || h->y < 0 || h->z < 0) return -1;
    return 0;
}

static float read_field(const uint8_t *rec, const PcdHeader *h, long f) {
    if (f < 0) return 0.0f;
    const uint8_t *p = rec + h->offsets[f];
    switch (h->types[f]) {
    case 'F':
        if (h->sizes[f] == 4) { float v; memcpy(&v, p, 4); return v; }
        else { double v; memcpy(&v, p, 8); return (float)v; }
    case 'U': {
        if (h->sizes[f] == 1) return (float)*p;
        if (h->sizes[f] == 2) { uint16_t v; memcpy(&v, p, 2); return (float)v; }
        uint32_t v; memcpy(&v, p, 4); return (float)v; }
    case 'I': {
        if (h->sizes[f] == 1) return (float)(int8_t)*p;
        if (h->sizes[f] == 2) { int16_t v; memcpy(&v, p, 2); return (float)v; }
        int32_t v; memcpy(&v, p, 4); return (float)v; }
    }
    return 0.0f;
}

/* Parse one PCD file into out (capacity*4 floats) + mask (capacity bytes).
 * Returns valid point count, or -1 on failure. */
static long pack_one(const char *path, long capacity,
                     float *out, uint8_t *mask) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;
    fseek(fp, 0, SEEK_END);
    long flen = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    uint8_t *buf = (uint8_t *)malloc(flen);
    if (!buf || fread(buf, 1, flen, fp) != (size_t)flen) {
        free(buf); fclose(fp); return -1;
    }
    fclose(fp);

    PcdHeader h;
    if (parse_header(buf, flen, &h) != 0) { free(buf); return -1; }

    for (long i = 0; i < capacity; ++i) {
        out[i * 4 + 0] = PAD_COORD;
        out[i * 4 + 1] = PAD_COORD;
        out[i * 4 + 2] = PAD_COORD;
        out[i * 4 + 3] = 0.0f;
        mask[i] = 0;
    }

    long k = h.n_points < capacity ? h.n_points : capacity;
    long written = 0;

    if (h.data_mode == 1) { /* binary, interleaved records */
        const uint8_t *data = buf + h.header_end;
        if (h.header_end + h.n_points * h.record_size > flen) k = 0;
        for (long i = 0; i < k; ++i) {
            const uint8_t *rec = data + i * h.record_size;
            float x = read_field(rec, &h, h.x);
            float y = read_field(rec, &h, h.y);
            float z = read_field(rec, &h, h.z);
            float inten = read_field(rec, &h, h.inten);
            out[i * 4 + 0] = x; out[i * 4 + 1] = y;
            out[i * 4 + 2] = z; out[i * 4 + 3] = inten;
            mask[i] = isfinite(x) && isfinite(y) && isfinite(z);
            ++written;
        }
    } else if (h.data_mode == 2) { /* binary_compressed, SoA payload */
        /* Bounds-validate everything that comes from the file before
         * trusting it: the 8-byte comp/uncomp header must fit, the
         * compressed payload must fit the file, and the SoA column extent
         * must fit the decompressed buffer (malformed/truncated PCDs would
         * otherwise drive out-of-bounds heap reads). */
        if (h.header_end + 8 > flen) { free(buf); return -1; }
        const uint8_t *p = buf + h.header_end;
        uint32_t comp, uncomp;
        memcpy(&comp, p, 4); memcpy(&uncomp, p + 4, 4);
        if ((long)comp > flen - h.header_end - 8 || uncomp == 0) {
            free(buf); return -1;
        }
        /* The SoA extraction below memcpys 4 bytes per coordinate; reject
         * clouds whose x/y/z/intensity columns are not 4-byte floats. */
        if (h.sizes[h.x] != 4 || h.sizes[h.y] != 4 || h.sizes[h.z] != 4 ||
            (h.inten >= 0 && h.sizes[h.inten] != 4)) {
            free(buf); return -1;
        }
        /* field-major: all x, then all y, ... column strides = size*n */
        long col_off[32];
        long off = 0;
        for (long f = 0; f < h.n_fields; ++f) {
            col_off[f] = off;
            off += h.sizes[f] * h.n_points;
        }
        if (off > (long)uncomp) { free(buf); return -1; }
        uint8_t *soa = (uint8_t *)malloc(uncomp);
        if (!soa || lzf_decompress(p + 8, comp, soa, uncomp) != (long)uncomp) {
            free(soa); free(buf); return -1;
        }
        for (long i = 0; i < k; ++i) {
            float x, y, z, inten = 0.0f;
            memcpy(&x, soa + col_off[h.x] + 4 * i, 4);
            memcpy(&y, soa + col_off[h.y] + 4 * i, 4);
            memcpy(&z, soa + col_off[h.z] + 4 * i, 4);
            if (h.inten >= 0)
                memcpy(&inten, soa + col_off[h.inten] + 4 * i, 4);
            out[i * 4 + 0] = x; out[i * 4 + 1] = y;
            out[i * 4 + 2] = z; out[i * 4 + 3] = inten;
            mask[i] = isfinite(x) && isfinite(y) && isfinite(z);
            ++written;
        }
        free(soa);
    } else { /* ascii */
        const char *p = (const char *)buf + h.header_end;
        const char *end = (const char *)buf + flen;
        for (long i = 0; i < k && p < end; ++i) {
            float vals[32] = {0};
            for (long f = 0; f < h.n_fields && p < end; ++f) {
                char *next;
                vals[f] = strtof(p, &next);
                if (next == p) { p = end; break; }
                p = next;
            }
            float x = vals[h.x], y = vals[h.y], z = vals[h.z];
            float inten = h.inten >= 0 ? vals[h.inten] : 0.0f;
            out[i * 4 + 0] = x; out[i * 4 + 1] = y;
            out[i * 4 + 2] = z; out[i * 4 + 3] = inten;
            mask[i] = isfinite(x) && isfinite(y) && isfinite(z);
            ++written;
        }
    }
    free(buf);
    return written;
}

typedef struct {
    const char **paths;
    long n_files;
    long capacity;
    float *out;       /* [n_files, capacity, 4] */
    uint8_t *mask;    /* [n_files, capacity] */
    long *counts;     /* [n_files] */
    long next;        /* work index */
    pthread_mutex_t lock;
} PackJob;

static void *worker(void *arg) {
    PackJob *job = (PackJob *)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        long i = job->next++;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->n_files) break;
        job->counts[i] = pack_one(
            job->paths[i], job->capacity,
            job->out + i * job->capacity * 4,
            job->mask + i * job->capacity);
    }
    return NULL;
}

/* Parse + pack n_files PCDs in parallel. Returns 0, or -1 if any file
 * failed (its count slot is -1, so the caller can name it). */
long pack_scans(const char **paths, long n_files, long capacity,
                long n_threads, float *out, uint8_t *mask, long *counts) {
    PackJob job = { paths, n_files, capacity, out, mask, counts, 0,
                    PTHREAD_MUTEX_INITIALIZER };
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_files) n_threads = n_files;
    if (n_threads > 64) n_threads = 64;
    pthread_t tids[64];
    for (long t = 0; t < n_threads; ++t)
        pthread_create(&tids[t], NULL, worker, &job);
    for (long t = 0; t < n_threads; ++t)
        pthread_join(tids[t], NULL);
    long rc = 0;
    for (long i = 0; i < n_files; ++i)
        if (counts[i] < 0) rc = -1;
    return rc;
}
