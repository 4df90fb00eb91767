/* libdctpu — native CPU runtime of data_compression_tpu_torch.
 *
 * The port's own copy of data_compression_tpu/native/libdctpu.c:
 * everything from the first #include to the end is that file's text
 * with one line added, sb_emit's refusal of word index 0xFF (scheme A
 * has 127 slots a context, so the original reads one past its row;
 * tests/test_torch_native.py holds the two equal up to that line).  It
 * carries the host halves the port runs on the CPU beside the card:
 *
 *   - the capped n-ary Huffman code-length builder
 *     (dct_huffman_capped_lengths_batch), under the main path's tables;
 *   - the serial codecs' cores and their OpenMP batch drivers: the
 *     16-context MTF nybble codec, context byte-LZW (small_byte) and
 *     context nybble-LZW (small_nybble), on the framework's wire spec;
 *   - CRC32 (zlib polynomial, slice-by-4);
 *   - canonical n-ary Huffman chunk encode/decode, bound for parity
 *     tests only.
 *
 * Exposed with a plain C ABI for ctypes (data_compression_tpu_torch/native).
 * All functions return the number of bytes produced, or a negative
 * error code.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

/* First slot >= `from` whose key equals `target`, or -1.  The child
 * search of both LZW schemes is "first slot matching (prefix, letter)"
 * — packing that pair into one u32 key per slot turns the 6-array
 * linear scan into a flat SIMD equality sweep with identical
 * first-match semantics.  `n` must be a multiple of 8 (pad slots carry
 * a sentinel key no target equals). */
static inline int key_find_next(const uint32_t *keys, int n, uint32_t target,
                                int from) {
    if (from >= n) return -1;
#ifdef __AVX512F__
    __m512i t16 = _mm512_set1_epi32((int)target);
    for (int s = from & ~15; s < n; s += 16) {
        __mmask16 m =
            _mm512_cmpeq_epi32_mask(_mm512_loadu_si512(keys + s), t16);
        if (s < from) m &= (__mmask16)~((1u << (from - s)) - 1);
        if (m) return s + __builtin_ctz((unsigned)m);
    }
    return -1;
#elif defined(__AVX2__)
    __m256i t = _mm256_set1_epi32((int)target);
    for (int s = from & ~7; s < n; s += 8) {
        __m256i k = _mm256_loadu_si256((const __m256i *)(keys + s));
        int m = _mm256_movemask_ps(
            _mm256_castsi256_ps(_mm256_cmpeq_epi32(k, t)));
        if (s < from) m &= ~((1 << (from - s)) - 1);
        if (m) return s + __builtin_ctz((unsigned)m);
    }
    return -1;
#else
    for (int s = from; s < n; s++)
        if (keys[s] == target) return s;
    return -1;
#endif
}

#define DCT_ERR_INPUT (-1)
#define DCT_ERR_CAPACITY (-2)
#define DCT_ERR_FORMAT (-3)

/* ------------------------------------------------------------------ */
/* CRC32 (zlib polynomial 0xEDB88320), slice-by-4                      */
/* ------------------------------------------------------------------ */

static uint32_t crc_tab[4][256];
static int crc_init_done = 0;

static void crc_init(void) {
    if (crc_init_done) return;
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_tab[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = crc_tab[0][i];
        for (int s = 1; s < 4; s++) {
            c = crc_tab[0][c & 0xFF] ^ (c >> 8);
            crc_tab[s][i] = c;
        }
    }
    crc_init_done = 1;
}

uint32_t dct_crc32(const uint8_t *p, int64_t n, uint32_t seed) {
    crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    while (n >= 4) {
        c ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
             ((uint32_t)p[3] << 24);
        c = crc_tab[3][c & 0xFF] ^ crc_tab[2][(c >> 8) & 0xFF] ^
            crc_tab[1][(c >> 16) & 0xFF] ^ crc_tab[0][c >> 24];
        p += 4;
        n -= 4;
    }
    while (n--) c = crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

/* ------------------------------------------------------------------ */
/* Nybble MTF codec (nybble_compression.c scheme; see models/nybble.py)*/
/* ------------------------------------------------------------------ */

#define NYB_TYPE 0xAF

typedef struct {
    uint8_t row[16][8];
} nyb_table;

static void nyb_init(nyb_table *t) {
    static const uint8_t seed[8] = {' ', 'e', 't', 'a', 'o', 'i', 'n', 's'};
    for (int c = 0; c < 16; c++) memcpy(t->row[c], seed, 8);
}

static inline int nyb_ctx(uint8_t b) { return (b >> 3) & 15; }

static inline void nyb_mtf(nyb_table *t, int ctx, uint8_t byte) {
    uint8_t *row = t->row[ctx];
    uint8_t nw = byte;
    for (int pos = 0; pos < 8; pos++) {
        uint8_t old = row[pos];
        row[pos] = nw;
        nw = old;
        if (nw == byte) break;
    }
}

int64_t dct_nybble_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap) {
    if (cap < 2) return DCT_ERR_CAPACITY;
    int64_t o = 0;
    dst[o++] = NYB_TYPE;
    if (n == 0) return o;
    dst[o++] = src[0];
    nyb_table t;
    nyb_init(&t);
    int pending = -1;
    for (int64_t i = 1; i < n; i++) {
        uint8_t p = src[i - 1], s = src[i];
        if ((p | s) & 0x80) return DCT_ERR_INPUT;
        int ctx = nyb_ctx(p);
        const uint8_t *row = t.row[ctx];
        int pos = -1;
        for (int k = 0; k < 8; k++)
            if (row[k] == s) { pos = k; break; }
        if (o + 2 > cap) return DCT_ERR_CAPACITY;
        if (pos >= 0) {
            int nyb = 0x8 | pos;
            if (pending < 0) pending = nyb;
            else { dst[o++] = (uint8_t)((pending << 4) | nyb); pending = -1; }
        } else {
            if (pending < 0) dst[o++] = s;
            else { dst[o++] = p; dst[o++] = s; pending = -1; }
        }
        nyb_mtf(&t, ctx, s);
    }
    if (pending >= 0) {
        if (o >= cap) return DCT_ERR_CAPACITY;
        dst[o++] = src[n - 1];
    }
    return o;
}

int64_t dct_nybble_decode(const uint8_t *payload, int64_t plen, uint8_t *dst,
                          int64_t raw_len) {
    if (raw_len == 0) return 0;
    if (plen < 2 || payload[0] != NYB_TYPE) return DCT_ERR_FORMAT;
    dst[0] = payload[1];
    const uint8_t *data = payload + 2;
    int64_t dlen = plen - 2;
    nyb_table t;
    nyb_init(&t);
    int64_t out = 1;
    int64_t j = 0;
    while (out < raw_len) {
        int64_t bi = j >> 1;
        if (bi >= dlen) return DCT_ERR_FORMAT;
        int nyb = (j & 1) ? (payload[2 + bi] & 0xF) : ((payload[2 + bi] >> 4) & 0xF);
        uint8_t o;
        int used;
        if (nyb & 0x8) {
            o = t.row[nyb_ctx(dst[out - 1])][nyb & 0x7];
            used = 1;
        } else {
            int64_t j2 = j + 1, b2 = j2 >> 1;
            if (b2 >= dlen) return DCT_ERR_FORMAT;
            int nxt = (j2 & 1) ? (data[b2] & 0xF) : ((data[b2] >> 4) & 0xF);
            o = (uint8_t)(((nyb & 0x7) << 4) | nxt);
            used = 2;
        }
        nyb_mtf(&t, nyb_ctx(dst[out - 1]), o);
        dst[out++] = o;
        j += used;
    }
    return out;
}

/* ------------------------------------------------------------------ */
/* Context byte-LZW (small_compression.c scheme A; see models/small.py)*/
/* ------------------------------------------------------------------ */

#define SB_TYPE 8
#define SB_CTX 32
#define SB_SLOTS 0x7F
#define SB_MAXWORD 256

/* Frozen-content span dictionary (see models/small.py).  A slot is
 * either its default (' ' + chr(i), start < 0) or an immutable span
 * (start, length) of the decoded output. */
#define SB_SLOTS_PAD 128 /* SB_SLOTS rounded up for the SIMD key sweep */
#define KEY_SENTINEL 0x80000000u

typedef struct {
    int64_t start[SB_CTX][SB_SLOTS];
    int64_t length[SB_CTX][SB_SLOTS];
    int64_t gen[SB_CTX][SB_SLOTS];
    int32_t prefix[SB_CTX][SB_SLOTS];
    int64_t prefix_gen[SB_CTX][SB_SLOTS];
    uint8_t letter[SB_CTX][SB_SLOTS];
    uint32_t key[SB_CTX][SB_SLOTS_PAD]; /* (prefix << 8) | letter */
    int32_t nwi[SB_CTX];
} sb_dict;

static void sb_init(sb_dict *d) {
    for (int c = 0; c < SB_CTX; c++) {
        for (int i = 0; i < SB_SLOTS; i++) {
            d->start[c][i] = -1;
            d->length[c][i] = 2;
            d->gen[c][i] = 0;
            d->prefix[c][i] = ' ';
            d->prefix_gen[c][i] = 0;
            d->letter[c][i] = (uint8_t)(i ? i : 'x');
            d->key[c][i] = ((uint32_t)' ' << 8) | d->letter[c][i];
        }
        for (int i = SB_SLOTS; i < SB_SLOTS_PAD; i++)
            d->key[c][i] = KEY_SENTINEL;
        d->nwi[c] = 0;
    }
}

static inline int sb_ctx(uint8_t b) { return b & (SB_CTX - 1); }

static void sb_add(sb_dict *d, int pctx, int pidx, int64_t ppos, int64_t plen,
                   uint8_t first_byte) {
    int s = d->nwi[pctx];
    d->start[pctx][s] = ppos;
    d->length[pctx][s] = plen + 1;
    d->gen[pctx][s] += 1;
    d->prefix[pctx][s] = pidx;
    d->prefix_gen[pctx][s] =
        (pidx >= 0x80) ? d->gen[pctx][pidx - 0x80] : 0;
    d->letter[pctx][s] = first_byte;
    d->key[pctx][s] = ((uint32_t)(pidx & 0xFFFF) << 8) | first_byte;
    d->nwi[pctx] = (s + 1) % SB_SLOTS;
}

/* Append index's word to out at position *outlen; returns word length. */
static int64_t sb_emit(const sb_dict *d, int ctx, int idx, uint8_t *out,
                       int64_t *outlen, int64_t out_cap) {
    if (idx < 0x80) {
        if (*outlen >= out_cap) return DCT_ERR_CAPACITY;
        out[(*outlen)++] = (uint8_t)idx;
        return 1;
    }
    int s = idx - 0x80;
    if (s >= SB_SLOTS) return DCT_ERR_FORMAT; /* 0xFF names no slot */
    int64_t st = d->start[ctx][s];
    int64_t ln = d->length[ctx][s];
    if (st < 0) {
        if (*outlen + 2 > out_cap) return DCT_ERR_CAPACITY;
        out[(*outlen)++] = ' ';
        out[(*outlen)++] = (uint8_t)(s ? s : 'x');
        return 2;
    }
    if (*outlen + ln > out_cap) return DCT_ERR_CAPACITY;
    for (int64_t k = 0; k < ln; k++) { /* byte-serial: self-overlap OK */
        out[*outlen] = out[st + k];
        (*outlen)++;
    }
    return ln;
}

static int sb_find_child(const sb_dict *d, int ctx, int idx, uint8_t c,
                         int banned) {
    uint32_t target = ((uint32_t)(idx & 0xFFFF) << 8) | c;
    const uint32_t *keys = d->key[ctx];
    for (int s = key_find_next(keys, SB_SLOTS_PAD, target, 0); s >= 0;
         s = key_find_next(keys, SB_SLOTS_PAD, target, s + 1)) {
        if (s == banned) continue;
        if (idx >= 0x80 && d->prefix_gen[ctx][s] != d->gen[ctx][idx - 0x80])
            continue;
        return s;
    }
    return -1;
}

int64_t dct_small_byte_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                              int64_t cap) {
    if (cap < 2) return DCT_ERR_CAPACITY;
    int64_t o = 0;
    dst[o++] = SB_TYPE;
    if (n == 0) return o;
    dst[o++] = src[0];
    /* heap per call: ctypes releases the GIL, so a static table would
     * race across Python threads (encode corruption surfaces only at
     * the decompress-side CRC) */
    sb_dict *d = (sb_dict *)malloc(sizeof *d);
    if (!d) return DCT_ERR_INPUT;
    sb_init(d);
    int pctx = sb_ctx(' ');
    int pidx = src[0];
    int64_t ppos = 0, plen = 1;
    int64_t pos = 1;
    int64_t ret = 0;
    while (pos < n) {
        if (src[pos] & 0x80 || src[pos - 1] & 0x80) {
            ret = DCT_ERR_INPUT;
            break;
        }
        int ctx = sb_ctx(src[pos - 1]);
        int banned = (ctx == pctx) ? d->nwi[pctx] : -1;
        int idx = src[pos];
        int64_t len = 1;
        while (pos + len < n && len < SB_MAXWORD - 1) {
            int w = sb_find_child(d, ctx, idx, src[pos + len], banned);
            if (w < 0) break;
            idx = 0x80 + w;
            len++;
        }
        if (o >= cap) {
            ret = DCT_ERR_CAPACITY;
            break;
        }
        dst[o++] = (uint8_t)idx;
        sb_add(d, pctx, pidx, ppos, plen, src[pos]);
        pctx = ctx;
        pidx = idx;
        ppos = pos;
        plen = len;
        pos += len;
    }
    free(d);
    return ret < 0 ? ret : o;
}

int64_t dct_small_byte_decode(const uint8_t *payload, int64_t plen_in,
                              uint8_t *dst, int64_t raw_len) {
    if (raw_len == 0) return 0;
    if (plen_in < 2 || payload[0] != SB_TYPE) return DCT_ERR_FORMAT;
    dst[0] = payload[1];
    sb_dict *d = (sb_dict *)malloc(sizeof *d); /* heap: see encode */
    if (!d) return DCT_ERR_INPUT;
    sb_init(d);
    int pctx = sb_ctx(' ');
    int pidx = payload[1];
    int64_t ppos = 0, plen = 1;
    int64_t out = 1;
    int64_t i = 2;
    int64_t ret = 0;
    while (out < raw_len) {
        if (i >= plen_in) {
            ret = DCT_ERR_FORMAT;
            break;
        }
        int idx = payload[i++];
        int ctx = sb_ctx(dst[out - 1]);
        int64_t pos = out;
        int64_t wl = sb_emit(d, ctx, idx, dst, &out, raw_len);
        if (wl < 0) {
            ret = DCT_ERR_FORMAT;
            break;
        }
        sb_add(d, pctx, pidx, ppos, plen, dst[pos]);
        pctx = ctx;
        pidx = idx;
        ppos = pos;
        plen = wl;
    }
    free(d);
    return ret < 0 ? ret : out;
}

/* ------------------------------------------------------------------ */
/* Context nybble-LZW (small_compression.c scheme B; models/small.py   */
/* small_nybble_* — bit-exact with the host Python implementation).    */
/* Words are frozen spans over the decoded NYBBLE stream; literal      */
/* indexes 0x10-0x1F are single nybbles (small_compression.c:803-805); */
/* slot allocation wraps 0x100 -> 0x80 (wraptype only_hi_bit_set,      */
/* :1343-1348).                                                        */
/* ------------------------------------------------------------------ */

#define SN_SLOTS 256
#define SN_MAXLEN (2 * 256 - 1) /* encoder match cap, in nybbles */

typedef struct {
    int64_t start[SB_CTX][SN_SLOTS];
    int64_t length[SB_CTX][SN_SLOTS];
    int64_t gen[SB_CTX][SN_SLOTS];
    int32_t prefix[SB_CTX][SN_SLOTS];
    int64_t prefix_gen[SB_CTX][SN_SLOTS];
    uint8_t letter[SB_CTX][SN_SLOTS];
    uint32_t key[SB_CTX][SN_SLOTS]; /* (prefix << 8) | letter; literal
                                       slots hold KEY_SENTINEL (the scan
                                       skips them) */
    int32_t nwi[SB_CTX];
} sn_table;

static inline int sn_is_lit(int x) { return (x | 0xF) == 0x1F; }

static void sn_init(sn_table *t) {
    for (int c = 0; c < SB_CTX; c++) {
        for (int i = 0; i < SN_SLOTS; i++) {
            t->start[c][i] = -1;
            t->length[c][i] = 0;
            t->gen[c][i] = 0;
            t->prefix[c][i] = (i & 0xF) | 0x10;
            t->prefix_gen[c][i] = 0;
            t->letter[c][i] = (uint8_t)((i >> 4) & 0xF);
            t->key[c][i] = sn_is_lit(i)
                               ? KEY_SENTINEL
                               : (((uint32_t)t->prefix[c][i] << 8) |
                                  t->letter[c][i]);
        }
        t->nwi[c] = 0x80;
    }
}

static void sn_add(sn_table *t, int pctx, int pidx, int64_t ppos,
                   int64_t plen, uint8_t first_nybble) {
    int s = t->nwi[pctx];
    t->start[pctx][s] = ppos;
    t->length[pctx][s] = plen + 1;
    t->gen[pctx][s] += 1;
    t->prefix[pctx][s] = pidx;
    if (pidx >= 0 && !sn_is_lit(pidx) && t->start[pctx][pidx] >= 0)
        t->prefix_gen[pctx][s] = t->gen[pctx][pidx];
    else
        t->prefix_gen[pctx][s] = 0;
    t->letter[pctx][s] = first_nybble;
    t->key[pctx][s] = ((uint32_t)(pidx & 0xFFFF) << 8) | first_nybble;
    int nxt = s + 1;
    if (nxt >= 0x100) nxt = 0x80;
    t->nwi[pctx] = nxt;
}

/* Append index's word to the nybble stream at *nn; returns word length
 * in nybbles. */
static int64_t sn_emit(const sn_table *t, int ctx, int idx, uint8_t *nybs,
                       int64_t *nn, int64_t cap) {
    if (sn_is_lit(idx)) {
        if (*nn >= cap) return DCT_ERR_CAPACITY;
        nybs[(*nn)++] = (uint8_t)(idx & 0xF);
        return 1;
    }
    int64_t st = t->start[ctx][idx];
    int64_t ln = t->length[ctx][idx];
    if (st < 0) { /* default: the byte's own two nybbles, low first */
        if (*nn + 2 > cap) return DCT_ERR_CAPACITY;
        nybs[(*nn)++] = (uint8_t)(idx & 0xF);
        nybs[(*nn)++] = (uint8_t)((idx >> 4) & 0xF);
        return 2;
    }
    if (*nn + ln > cap) return DCT_ERR_CAPACITY;
    for (int64_t k = 0; k < ln; k++) { /* nybble-serial: overlap OK */
        nybs[*nn] = nybs[st + k];
        (*nn)++;
    }
    return ln;
}

static int sn_find_child(const sn_table *t, int ctx, int idx, uint8_t nyb,
                         int banned) {
    int chk = !sn_is_lit(idx);
    int64_t want = 0;
    if (chk && idx >= 0 && t->start[ctx][idx] >= 0) want = t->gen[ctx][idx];
    uint32_t target = ((uint32_t)(idx & 0xFFFF) << 8) | nyb;
    const uint32_t *keys = t->key[ctx];
    /* Slots < 0x80 are immutable defaults (nwi starts at 0x80 and wraps
     * back to 0x80, small_compression.c:1343-1348), and a default
     * (prefix, letter) pair is unique — so a literal-prefix search with
     * nyb < 8 hits its default slot d0 < 0x80 unconditionally (banned
     * >= 0x80 and literal prefixes carry no gen check), and every other
     * search can start the sweep at 0x80. */
    if (!chk) {
        int d0 = (idx & 0xF) | ((int)nyb << 4);
        /* nyb == 1 puts d0 in the literal range 0x10-0x1F, which the
         * child search never matches (sn_is_lit skip) */
        if (d0 < 0x80 && !sn_is_lit(d0)) return d0;
    }
    for (int s = key_find_next(keys, SN_SLOTS, target, 0x80); s >= 0;
         s = key_find_next(keys, SN_SLOTS, target, s + 1)) {
        if (s == banned) continue;
        if (chk && t->prefix_gen[ctx][s] != want) continue;
        return s;
    }
    return -1;
}

int64_t dct_small_nybble_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                                int64_t cap) {
    if (cap < 2) return DCT_ERR_CAPACITY;
    int64_t o = 0;
    dst[o++] = SB_TYPE;
    if (n == 0) return o;
    dst[o++] = src[0];
    uint8_t *nybs = (uint8_t *)malloc((size_t)(2 * n));
    if (!nybs) return DCT_ERR_INPUT;
    for (int64_t i = 0; i < n; i++) {
        nybs[2 * i] = src[i] & 0xF;
        nybs[2 * i + 1] = (uint8_t)((src[i] >> 4) & 0xF);
    }
    /* heap per call: ctypes releases the GIL, so a static table would
     * race across Python threads */
    sn_table *t = (sn_table *)malloc(sizeof *t);
    if (!t) {
        free(nybs);
        return DCT_ERR_INPUT;
    }
    sn_init(t);
    int pctx = sb_ctx(' ');
    int pidx = -1; /* the verbatim first byte is not an index */
    int64_t ppos = 0, plen = 2;
    int64_t N = 2 * n, pos = 2;
    int64_t ret = 0;
    while (pos < N) {
        int ctx = sb_ctx(src[pos / 2 - 1]);
        int banned = (ctx == pctx) ? t->nwi[pctx] : -1;
        int idx = nybs[pos] | 0x10;
        int64_t len = 1;
        while (pos + len < N && len < SN_MAXLEN) {
            int w = sn_find_child(t, ctx, idx, nybs[pos + len], banned);
            if (w < 0) break;
            idx = w;
            len++;
        }
        if (o >= cap) {
            ret = DCT_ERR_CAPACITY;
            break;
        }
        dst[o++] = (uint8_t)idx;
        sn_add(t, pctx, pidx, ppos, plen, nybs[pos]);
        pctx = ctx;
        pidx = idx;
        ppos = pos;
        plen = len;
        pos += len;
    }
    free(t);
    free(nybs);
    return ret < 0 ? ret : o;
}

int64_t dct_small_nybble_decode(const uint8_t *payload, int64_t plen_in,
                                uint8_t *dst, int64_t raw_len) {
    if (raw_len == 0) return 0;
    if (plen_in < 2 || payload[0] != SB_TYPE) return DCT_ERR_FORMAT;
    int64_t target = 2 * raw_len;
    uint8_t *nybs = (uint8_t *)malloc((size_t)target);
    if (!nybs) return DCT_ERR_INPUT;
    sn_table *t = (sn_table *)malloc(sizeof *t); /* heap: see encode */
    if (!t) {
        free(nybs);
        return DCT_ERR_INPUT;
    }
    sn_init(t);
    nybs[0] = payload[1] & 0xF;
    nybs[1] = (uint8_t)((payload[1] >> 4) & 0xF);
    int64_t nn = 2;
    int pctx = sb_ctx(' ');
    int pidx = -1;
    int64_t ppos = 0, plen = 2;
    int64_t i = 2;
    int64_t ret = 0;
    while (nn < target) {
        if (i >= plen_in) {
            ret = DCT_ERR_FORMAT;
            break;
        }
        int idx = payload[i++];
        int64_t done = nn / 2; /* complete output bytes so far */
        int ctx =
            sb_ctx((uint8_t)(nybs[2 * done - 2] | (nybs[2 * done - 1] << 4)));
        int64_t pos = nn;
        int64_t wl = sn_emit(t, ctx, idx, nybs, &nn, target);
        if (wl < 0) {
            ret = DCT_ERR_FORMAT; /* decoded past expected length */
            break;
        }
        sn_add(t, pctx, pidx, ppos, plen, nybs[pos]);
        pctx = ctx;
        pidx = idx;
        ppos = pos;
        plen = wl;
    }
    if (ret == 0)
        for (int64_t k = 0; k < raw_len; k++)
            dst[k] = (uint8_t)(nybs[2 * k] | (nybs[2 * k + 1] << 4));
    free(t);
    free(nybs);
    return ret < 0 ? ret : raw_len;
}

/* ------------------------------------------------------------------ */
/* Host Huffman table build, batched.  Semantics are bit-identical to  */
/* huffman/tree.py (two-queue merge over a stable (count, seniority)   */
/* order, reference-faithful dummy nodes with the % (n-1) fix of       */
/* n_ary_huffman.c:900-916, capped_lengths' halving rescale) —         */
/* differential-tested in tests/test_table_batch.py.  One block costs  */
/* O(S log S); OpenMP parallelizes across blocks.                      */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t count;
    int32_t idx;
} hl_item;

static int hl_cmp(const void *a, const void *b) {
    const hl_item *x = (const hl_item *)a, *y = (const hl_item *)b;
    if (x->count != y->count) return x->count < y->count ? -1 : 1;
    return x->idx < y->idx ? -1 : 1; /* stable: seniority by index */
}

/* Lengths for one histogram; returns max leaf length (or <0 error).
 * S <= 256; scratch sized for S + arity dummies + internals. */
static int hl_once(const int64_t *freqs, int S, int arity, int32_t *out) {
    int32_t used[256];
    int k = 0;
    for (int s = 0; s < S; s++) {
        out[s] = 0;
        if (freqs[s] > 0) used[k++] = s;
    }
    if (k == 0) return 0;
    if (k == 1) {
        out[used[0]] = 1;
        return 1;
    }
    int n1 = arity - 1;
    int d = (n1 - ((k - 1) % n1)) % n1;
    int nl = k + d;
    hl_item items[256 + 64];
    for (int i = 0; i < k; i++) {
        items[i].count = freqs[used[i]];
        items[i].idx = i;
    }
    for (int i = k; i < nl; i++) {
        items[i].count = 1; /* dummies get minimum count 1 */
        items[i].idx = i;
    }
    qsort(items, (size_t)nl, sizeof(hl_item), hl_cmp);
    /* two queues: sorted leaves + FIFO of internal nodes */
    int total_nodes = nl + (nl - 1) / n1;
    int32_t parent[2 * (256 + 64)];
    int64_t node_count[256 + 64];
    int32_t node_id[256 + 64];
    int lq = 0, nq_head = 0, nq_tail = 0;
    int next_id = nl;
    int remaining = nl;
    while (remaining > 1) {
        int64_t total = 0;
        for (int a = 0; a < arity; a++) {
            int64_t c;
            int32_t id;
            if (lq < nl && (nq_head == nq_tail ||
                            items[lq].count <= node_count[nq_head])) {
                c = items[lq].count;
                id = items[lq].idx;
                lq++;
            } else {
                c = node_count[nq_head];
                id = node_id[nq_head];
                nq_head++;
            }
            parent[id] = next_id;
            total += c;
        }
        node_count[nq_tail] = total;
        node_id[nq_tail] = next_id;
        nq_tail++;
        /* FIFO head never outruns tail; reuse of consumed slots is
         * unnecessary at these sizes */
        next_id++;
        remaining -= n1;
    }
    int root = next_id - 1;
    int32_t depth[2 * (256 + 64)];
    depth[root] = 0;
    int maxlen = 0;
    for (int i = root - 1; i >= 0; i--) {
        depth[i] = depth[parent[i]] + 1;
        if (i < k && depth[i] > maxlen) maxlen = depth[i];
    }
    (void)total_nodes;
    for (int i = 0; i < k; i++) out[used[i]] = depth[i];
    return maxlen;
}

/* capped_lengths semantics (models/huffman.py): halve (flatten)
 * frequencies until the optimal tree fits the per-arity cap. */
int64_t dct_huffman_capped_lengths(const int64_t *freqs, int S, int arity,
                                   int cap, int32_t *out) {
    if (S > 256 || arity < 2 || arity > 64) return DCT_ERR_INPUT;
    int64_t f[256];
    for (int s = 0; s < S; s++) f[s] = freqs[s];
    for (;;) {
        int ml = hl_once(f, S, arity, out);
        if (ml < 0) return ml;
        if (ml <= cap) return ml;
        for (int s = 0; s < S; s++)
            if (f[s] > 0) f[s] = (f[s] + 1) / 2;
    }
}

void dct_huffman_capped_lengths_batch(const int64_t *hists, int64_t nb,
                                      int S, int arity, int cap,
                                      int32_t *out, int64_t *status) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nb; i++)
        status[i] = dct_huffman_capped_lengths(hists + i * S, S, arity, cap,
                                               out + i * S);
}

/* ------------------------------------------------------------------ */
/* Batched serial-codec drivers.  Blocks are independent (the framing  */
/* guarantees it; SURVEY.md §3.3 block-parallel strategy), so the host */
/* parallelizes ACROSS blocks with OpenMP — the CPU mirror of the      */
/* one-block-per-lane device layout.  src: one contiguous buffer with  */
/* per-block (offset, length); dst: nb rows of dst_stride bytes;       */
/* out_len[i]: bytes produced or a negative error code for block i.    */
/* ------------------------------------------------------------------ */

typedef int64_t (*dct_block_fn)(const uint8_t *, int64_t, uint8_t *, int64_t);

static void batch_run(dct_block_fn fn, const uint8_t *src, const int64_t *off,
                      const int64_t *len, uint8_t *dst, int64_t dst_stride,
                      int64_t *out_len, int64_t nb) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < nb; i++)
        out_len[i] = fn(src + off[i], len[i], dst + i * dst_stride, dst_stride);
}

void dct_nybble_encode_batch(const uint8_t *src, const int64_t *off,
                             const int64_t *len, uint8_t *dst,
                             int64_t dst_stride, int64_t *out_len,
                             int64_t nb) {
    batch_run(dct_nybble_encode, src, off, len, dst, dst_stride, out_len, nb);
}

void dct_small_byte_encode_batch(const uint8_t *src, const int64_t *off,
                                 const int64_t *len, uint8_t *dst,
                                 int64_t dst_stride, int64_t *out_len,
                                 int64_t nb) {
    batch_run(dct_small_byte_encode, src, off, len, dst, dst_stride, out_len,
              nb);
}

void dct_small_nybble_encode_batch(const uint8_t *src, const int64_t *off,
                                   const int64_t *len, uint8_t *dst,
                                   int64_t dst_stride, int64_t *out_len,
                                   int64_t nb) {
    batch_run(dct_small_nybble_encode, src, off, len, dst, dst_stride,
              out_len, nb);
}

/* Decode batch: payload i at src+off[i] (len[i] bytes) decodes to
 * raw_len[i] bytes at dst + i*dst_stride. */
static void batch_run_dec(dct_block_fn fn, const uint8_t *src,
                          const int64_t *off, const int64_t *len,
                          const int64_t *raw_len, uint8_t *dst,
                          int64_t dst_stride, int64_t *out_len, int64_t nb) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < nb; i++)
        out_len[i] =
            fn(src + off[i], len[i], dst + i * dst_stride, raw_len[i]);
}

void dct_nybble_decode_batch(const uint8_t *src, const int64_t *off,
                             const int64_t *len, const int64_t *raw_len,
                             uint8_t *dst, int64_t dst_stride,
                             int64_t *out_len, int64_t nb) {
    batch_run_dec(dct_nybble_decode, src, off, len, raw_len, dst, dst_stride,
                  out_len, nb);
}

void dct_small_byte_decode_batch(const uint8_t *src, const int64_t *off,
                                 const int64_t *len, const int64_t *raw_len,
                                 uint8_t *dst, int64_t dst_stride,
                                 int64_t *out_len, int64_t nb) {
    batch_run_dec(dct_small_byte_decode, src, off, len, raw_len, dst,
                  dst_stride, out_len, nb);
}

void dct_small_nybble_decode_batch(const uint8_t *src, const int64_t *off,
                                   const int64_t *len, const int64_t *raw_len,
                                   uint8_t *dst, int64_t dst_stride,
                                   int64_t *out_len, int64_t nb) {
    batch_run_dec(dct_small_nybble_decode, src, off, len, raw_len, dst,
                  dst_stride, out_len, nb);
}

/* ------------------------------------------------------------------ */
/* Canonical n-ary Huffman chunk encode/decode (framework wire format) */
/* ------------------------------------------------------------------ */

static const int DPB[17] = {0, 0, 8, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2};

/* Encode one chunk. packed/bits: per-symbol little-endian field codes
 * (ops/encode_fast.pack_encode_table layout). bpd: 1/2/4.  Returns
 * bytes written. */
int64_t dct_huffman_encode_chunk(const uint8_t *syms, int64_t n, int arity,
                                 const uint32_t *packed, const int32_t *bits,
                                 uint8_t *dst, int64_t cap) {
    int bpd = arity == 2 ? 1 : (arity == 3 ? 2 : 4);
    int dpb = DPB[arity];
    if (!dpb) return DCT_ERR_INPUT;
    if (arity == 3) {
        /* digit stream -> 5 trits per byte */
        int64_t o = 0;
        int fill = 0;
        int mul = 1;
        int acc = 0;
        for (int64_t i = 0; i < n; i++) {
            uint32_t w = packed[syms[i]];
            int nb = bits[syms[i]] / bpd;
            for (int m = 0; m < nb; m++) {
                int digit = (int)((w >> (2 * m)) & 3);
                acc += digit * mul;
                mul *= 3;
                if (++fill == 5) {
                    if (o >= cap) return DCT_ERR_CAPACITY;
                    dst[o++] = (uint8_t)acc;
                    acc = 0; mul = 1; fill = 0;
                }
            }
        }
        if (fill) {
            if (o >= cap) return DCT_ERR_CAPACITY;
            dst[o++] = (uint8_t)acc;
        }
        return o;
    }
    /* bit-field codecs (n=2: 1 bit, n=16: 4 bits) pack directly */
    uint64_t buf = 0;
    int nb = 0;
    int64_t o = 0;
    for (int64_t i = 0; i < n; i++) {
        buf |= (uint64_t)packed[syms[i]] << nb;
        nb += bits[syms[i]];
        while (nb >= 8) {
            if (o >= cap) return DCT_ERR_CAPACITY;
            dst[o++] = (uint8_t)(buf & 0xFF);
            buf >>= 8;
            nb -= 8;
        }
    }
    if (nb) {
        if (o >= cap) return DCT_ERR_CAPACITY;
        dst[o++] = (uint8_t)(buf & 0xFF);
    }
    return o;
}

/* Decode one chunk of `count` symbols.  Tables are the scaled decode
 * tables (huffman/canonical.build_decode_tables): limit_scaled and
 * base_minus_first indexed by length 1..L, symbols by canonical rank.
 * L = padded max length (15 or 7). */
int64_t dct_huffman_decode_chunk(const uint8_t *payload, int64_t plen,
                                 int64_t count, int arity, int L,
                                 const int64_t *limit_scaled,
                                 const int64_t *base_minus_first,
                                 const int32_t *symbols, uint8_t *out) {
    int dpb = DPB[arity];
    if (!dpb) return DCT_ERR_INPUT;
    /* unpack digits (little-endian within byte) */
    int64_t ndig = plen * dpb;
    /* digit fetch helper */
    int64_t off = 0;
    int64_t npl = 1;
    for (int i = 0; i < L; i++) npl *= arity;
    for (int64_t i = 0; i < count; i++) {
        /* window value of L digits, MSB-first */
        int64_t w = 0;
        for (int k = 0; k < L; k++) {
            int64_t j = off + k;
            int d = 0;
            if (j < ndig) {
                int b = payload[j / dpb];
                switch (arity) {
                    case 2: d = (b >> (j % 8)) & 1; break;
                    case 3: {
                        int t = b;
                        for (int q = 0; q < j % 5; q++) t /= 3;
                        d = t % 3;
                        break;
                    }
                    default: d = (b >> (4 * (j % 2))) & 0xF; break;
                }
            }
            w = w * arity + d;
        }
        int ln = 1;
        while (ln <= L && w >= limit_scaled[ln]) ln++;
        if (ln > L) return DCT_ERR_FORMAT;
        int64_t scale = npl;
        for (int q = 0; q < ln; q++) scale /= arity;
        int64_t value = w / scale;
        int64_t sidx = base_minus_first[ln] + value;
        /* Host-validated tables (Kraft check in huffman/canonical.py)
         * guarantee sidx < 256, but corrupted payloads must never
         * turn into an OOB read even if a future caller skips that
         * validation — bound-check in C too. */
        if (sidx < 0 || sidx >= 256) return DCT_ERR_FORMAT;
        out[i] = (uint8_t)symbols[sidx];
        off += ln;
    }
    return count;
}
