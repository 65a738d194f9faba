/* PIZ (wavelet + Huffman) decompression for OpenEXR scanline chunks:
 * the port's copy of mcpt_tpu/native/piz.c, code for code.
 *
 * Implements the PIZ pipeline from the OpenEXR format specification
 * ("Technical Introduction to OpenEXR" + the ILM file-format docs):
 * bitmap -> reverse LUT, canonical Huffman decode (16-bit symbols,
 * 14-bit fast decode table), 2D Haar-like wavelet inverse (w14/w16),
 * LUT application.  Used by mcpt_tpu_torch.utils.image.read_exr for
 * EXR goldens and envmap assets.
 *
 * Derivation note: the Huffman table construction and wavelet
 * inverse closely follow the structure of the BSD-licensed OpenEXR
 * reference implementation (ILM's ImfHuf.cpp / ImfWav.cpp) — much of
 * that shape is format-mandated (the decoder must be bit-identical to
 * ILM's encoder), and this file should be read as a C re-derivation
 * of that public reference code, not an independent design.
 *
 * Host code, not a device kernel: compiled by mcpt_tpu_torch.native
 * (gcc -O2 -fPIC -shared into mcpt_tpu_torch/_build/), called via ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define USHORT_RANGE 65536
#define BITMAP_SIZE 8192

#define HUF_ENCBITS 16
#define HUF_DECBITS 14
#define HUF_ENCSIZE ((1 << HUF_ENCBITS) + 1)
#define HUF_DECSIZE (1 << HUF_DECBITS)
#define HUF_DECMASK (HUF_DECSIZE - 1)

#define SHORT_ZEROCODE_RUN 59
#define LONG_ZEROCODE_RUN 63
#define SHORTEST_LONG_RUN (2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN)

typedef struct {
    int32_t len;     /* code length if <= HUF_DECBITS */
    uint32_t lit;    /* literal for short codes / count of long codes */
    uint32_t *p;     /* long-code symbol list */
} HufDec;

/* ---------------- bit reader ---------------- */

typedef struct {
    const uint8_t *p;
    const uint8_t *end;
    uint64_t c;
    int lc;
} BitIn;

static inline int get_bits(BitIn *in, int n, uint64_t *out) {
    while (in->lc < n) {
        if (in->p >= in->end) return -1;
        in->c = (in->c << 8) | *in->p++;
        in->lc += 8;
    }
    in->lc -= n;
    *out = (in->c >> in->lc) & ((1ULL << n) - 1);
    return 0;
}

/* ---------------- Huffman ---------------- */

static void canonical_code_table(uint64_t *hcode) {
    uint64_t n[59], c = 0;
    int i;
    for (i = 0; i <= 58; ++i) n[i] = 0;
    for (i = 0; i < HUF_ENCSIZE; ++i) n[hcode[i]] += 1;
    for (i = 58; i > 0; --i) {
        uint64_t nc = (c + n[i]) >> 1;
        n[i] = c;
        c = nc;
    }
    for (i = 0; i < HUF_ENCSIZE; ++i) {
        int l = (int)hcode[i];
        if (l > 0) hcode[i] = ((uint64_t)l) | (n[l]++ << 6);
    }
}

static int unpack_enc_table(BitIn *in, int im, int iM, uint64_t *hcode) {
    memset(hcode, 0, sizeof(uint64_t) * HUF_ENCSIZE);
    for (; im <= iM; im++) {
        uint64_t l;
        if (get_bits(in, 6, &l)) return -1;
        hcode[im] = l;
        if (l == LONG_ZEROCODE_RUN) {
            uint64_t zerun;
            if (get_bits(in, 8, &zerun)) return -1;
            zerun += SHORTEST_LONG_RUN;
            if (im + (int)zerun > iM + 1) return -2;
            while (zerun--) hcode[im++] = 0;
            im--;
        } else if (l >= SHORT_ZEROCODE_RUN) {
            uint64_t zerun = l - SHORT_ZEROCODE_RUN + 2;
            if (im + (int)zerun > iM + 1) return -2;
            while (zerun--) hcode[im++] = 0;
            im--;
        }
    }
    canonical_code_table(hcode);
    return 0;
}

static int build_dec_table(const uint64_t *hcode, int im, int iM,
                           HufDec *hdecod) {
    memset(hdecod, 0, sizeof(HufDec) * HUF_DECSIZE);
    for (; im <= iM; im++) {
        uint64_t c = hcode[im] >> 6;
        int l = (int)(hcode[im] & 63);
        if (c >> l) return -3;
        if (l > HUF_DECBITS) {
            HufDec *pl = hdecod + (c >> (l - HUF_DECBITS));
            if (pl->len) return -3;
            pl->lit++;
            pl->p = (uint32_t *)realloc(pl->p, pl->lit * sizeof(uint32_t));
            pl->p[pl->lit - 1] = (uint32_t)im;
        } else if (l) {
            HufDec *pl = hdecod + (c << (HUF_DECBITS - l));
            int i;
            for (i = 1 << (HUF_DECBITS - l); i > 0; i--, pl++) {
                if (pl->len || pl->p) return -3;
                pl->len = l;
                pl->lit = (uint32_t)im;
            }
        }
    }
    return 0;
}

static void free_dec_table(HufDec *hdecod) {
    int i;
    for (i = 0; i < HUF_DECSIZE; ++i)
        if (hdecod[i].p) {
            free(hdecod[i].p);
            hdecod[i].p = NULL;
        }
}

static int huf_decode(const uint64_t *hcode, const HufDec *hdecod,
                      const uint8_t *in, long ni_bits, int rlc, long no,
                      uint16_t *out) {
    uint64_t c = 0;
    int lc = 0;
    long oi = 0;
    uint16_t *outp = out;
    const uint8_t *ie = in + (ni_bits + 7) / 8;

    while (in < ie) {
        c = (c << 8) | *in++;
        lc += 8;
        while (lc >= HUF_DECBITS) {
            const HufDec *pl = hdecod + ((c >> (lc - HUF_DECBITS)) & HUF_DECMASK);
            if (pl->len) {
                lc -= pl->len;
                {
                    /* inline RLE handling using (c, lc) state */
                    uint32_t po = pl->lit;
                    if ((int)po == rlc) {
                        uint64_t cs;
                        if (lc < 8) {
                            if (in >= ie) return -1;
                            c = (c << 8) | *in++;
                            lc += 8;
                        }
                        lc -= 8;
                        cs = (c >> lc) & 0xff;
                        if (oi + (long)cs > no || oi == 0) return -4;
                        {
                            uint16_t s = outp[-1];
                            while (cs-- > 0) { *outp++ = s; oi++; }
                        }
                    } else {
                        if (oi >= no) return -4;
                        *outp++ = (uint16_t)po;
                        oi++;
                    }
                }
            } else {
                /* long code: search the symbol list */
                uint32_t j;
                int found = 0;
                if (!pl->p) return -3;
                for (j = 0; j < pl->lit; j++) {
                    int l = (int)(hcode[pl->p[j]] & 63);
                    while (lc < l && in < ie) {
                        c = (c << 8) | *in++;
                        lc += 8;
                    }
                    if (lc >= l &&
                        (hcode[pl->p[j]] >> 6) ==
                            ((c >> (lc - l)) & ((1ULL << l) - 1))) {
                        lc -= l;
                        {
                            uint32_t po = pl->p[j];
                            if ((int)po == rlc) {
                                uint64_t cs;
                                if (lc < 8) {
                                    if (in >= ie) return -1;
                                    c = (c << 8) | *in++;
                                    lc += 8;
                                }
                                lc -= 8;
                                cs = (c >> lc) & 0xff;
                                if (oi + (long)cs > no || oi == 0) return -4;
                                {
                                    uint16_t s = outp[-1];
                                    while (cs-- > 0) { *outp++ = s; oi++; }
                                }
                            } else {
                                if (oi >= no) return -4;
                                *outp++ = (uint16_t)po;
                                oi++;
                            }
                        }
                        found = 1;
                        break;
                    }
                }
                if (!found) return -3;
            }
        }
    }

    /* flush remaining bits (the encoder pads with up to 8 zero bits) */
    {
        int i = (8 - (int)(ni_bits & 7)) & 7;
        c >>= i;
        lc -= i;
        while (lc > 0) {
            const HufDec *pl = hdecod + ((c << (HUF_DECBITS - lc)) & HUF_DECMASK);
            if (pl->len && pl->len <= lc) {
                lc -= pl->len;
                {
                    uint32_t po = pl->lit;
                    if ((int)po == rlc) {
                        uint64_t cs;
                        if (lc < 8) return -1;
                        lc -= 8;
                        cs = (c >> lc) & 0xff;
                        if (oi + (long)cs > no || oi == 0) return -4;
                        {
                            uint16_t s = outp[-1];
                            while (cs-- > 0) { *outp++ = s; oi++; }
                        }
                    } else {
                        if (oi >= no) return -4;
                        *outp++ = (uint16_t)po;
                        oi++;
                    }
                }
            } else {
                break;
            }
        }
    }

    return (oi == no) ? 0 : -5;
}

static int huf_uncompress(const uint8_t *compressed, long n_compressed,
                          uint16_t *raw, long n_raw) {
    uint32_t im, iM, nBits;
    uint64_t *freq;
    HufDec *hdec;
    BitIn in;
    int ret;

    if (n_compressed < 20) return -1;
    im = *(const uint32_t *)(compressed + 0);
    iM = *(const uint32_t *)(compressed + 4);
    nBits = *(const uint32_t *)(compressed + 12);
    if (im >= HUF_ENCSIZE || iM >= HUF_ENCSIZE) return -2;

    freq = (uint64_t *)malloc(sizeof(uint64_t) * HUF_ENCSIZE);
    hdec = (HufDec *)malloc(sizeof(HufDec) * HUF_DECSIZE);
    in.p = compressed + 20;
    in.end = compressed + n_compressed;
    in.c = 0;
    in.lc = 0;

    ret = unpack_enc_table(&in, (int)im, (int)iM, freq);
    if (ret == 0) ret = build_dec_table(freq, (int)im, (int)iM, hdec);
    if (ret == 0)
        ret = huf_decode(freq, hdec, in.p, (long)nBits, (int)iM, n_raw, raw);
    free_dec_table(hdec);
    free(hdec);
    free(freq);
    return ret;
}

/* ---------------- wavelet ---------------- */

#define NBITS 16
#define A_OFFSET (1 << (NBITS - 1))
#define MOD_MASK ((1 << NBITS) - 1)

static inline void wdec14(uint16_t l, uint16_t h, uint16_t *a, uint16_t *b) {
    int16_t ls = (int16_t)l;
    int16_t hs = (int16_t)h;
    int hi = hs;
    int ai = ls + (hi & 1) + (hi >> 1);
    int16_t as = (int16_t)ai;
    int16_t bs = (int16_t)(ai - hi);
    *a = (uint16_t)as;
    *b = (uint16_t)bs;
}

static inline void wdec16(uint16_t l, uint16_t h, uint16_t *a, uint16_t *b) {
    int m = l;
    int d = h;
    int bb = (m - (d >> 1)) & MOD_MASK;
    int aa = (d + bb - A_OFFSET) & MOD_MASK;
    *b = (uint16_t)bb;
    *a = (uint16_t)aa;
}

static void wav2_decode(uint16_t *in, int nx, int ox, int ny, int oy,
                        uint16_t mx) {
    int w14 = (mx < (1 << 14));
    int n = (nx > ny) ? ny : nx;
    int p = 1;
    int p2;

    while (p <= n) p <<= 1;
    p >>= 1;
    p2 = p;
    p >>= 1;

    while (p >= 1) {
        uint16_t *py = in;
        uint16_t *ey = in + oy * (ny - p2);
        int oy1 = oy * p;
        int oy2 = oy * p2;
        int ox1 = ox * p;
        int ox2 = ox * p2;
        uint16_t i00, i01, i10, i11;

        for (; py <= ey; py += oy2) {
            uint16_t *px = py;
            uint16_t *ex = py + ox * (nx - p2);

            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                uint16_t *p10 = px + oy1;
                uint16_t *p11 = p10 + ox1;

                if (w14) {
                    wdec14(*px, *p10, &i00, &i10);
                    wdec14(*p01, *p11, &i01, &i11);
                    wdec14(i00, i01, px, p01);
                    wdec14(i10, i11, p10, p11);
                } else {
                    wdec16(*px, *p10, &i00, &i10);
                    wdec16(*p01, *p11, &i01, &i11);
                    wdec16(i00, i01, px, p01);
                    wdec16(i10, i11, p10, p11);
                }
            }

            if (nx & p) {
                uint16_t *p10 = px + oy1;
                if (w14)
                    wdec14(*px, *p10, &i00, p10);
                else
                    wdec16(*px, *p10, &i00, p10);
                *px = i00;
            }
        }

        if (ny & p) {
            uint16_t *px = py;
            uint16_t *ex = py + ox * (nx - p2);
            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                if (w14)
                    wdec14(*px, *p01, &i00, p01);
                else
                    wdec16(*px, *p01, &i00, p01);
                *px = i00;
            }
        }

        p2 = p;
        p >>= 1;
    }
}

/* ---------------- LUT ---------------- */

static uint16_t reverse_lut_from_bitmap(const uint8_t *bitmap, uint16_t *lut) {
    int i, k = 0;
    for (i = 0; i < USHORT_RANGE; ++i) {
        if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = (uint16_t)i;
    }
    {
        int n = k - 1;
        while (k < USHORT_RANGE) lut[k++] = 0;
        return (uint16_t)n;
    }
}

/* ---------------- public entry ---------------- */

/* Decompress one PIZ chunk.
 * in/in_len: raw chunk payload (after the y/size ints).
 * n_channels, nx[i], ny[i]: per-channel sample counts in this chunk
 *   (header channel order; half = 1 short per sample assumed).
 * out: planar output, channel-major, ny[i] rows of nx[i] shorts each.
 * Returns 0 on success, negative error code otherwise. */
int piz_uncompress(const uint8_t *in, long in_len, int n_channels,
                   const int *nx, const int *ny, uint16_t *out,
                   long out_count) {
    uint8_t bitmap[BITMAP_SIZE];
    uint16_t *lut;
    uint16_t max_value;
    uint16_t min_nonzero, max_nonzero;
    const uint8_t *ptr = in;
    long remaining = in_len;
    int32_t hlen;
    long total = 0;
    int c, ret;

    for (c = 0; c < n_channels; ++c) total += (long)nx[c] * ny[c];
    if (total != out_count) return -10;

    if (remaining < 4) return -11;
    min_nonzero = *(const uint16_t *)ptr;
    max_nonzero = *(const uint16_t *)(ptr + 2);
    ptr += 4;
    remaining -= 4;

    memset(bitmap, 0, BITMAP_SIZE);
    if (max_nonzero >= BITMAP_SIZE) return -12;
    if (min_nonzero <= max_nonzero) {
        long n = max_nonzero - min_nonzero + 1;
        if (remaining < n) return -11;
        memcpy(bitmap + min_nonzero, ptr, n);
        ptr += n;
        remaining -= n;
    }

    lut = (uint16_t *)malloc(sizeof(uint16_t) * USHORT_RANGE);
    max_value = reverse_lut_from_bitmap(bitmap, lut);

    if (remaining < 4) {
        free(lut);
        return -11;
    }
    hlen = *(const int32_t *)ptr;
    ptr += 4;
    remaining -= 4;
    if (hlen < 0 || hlen > remaining) {
        free(lut);
        return -11;
    }

    ret = huf_uncompress(ptr, hlen, out, out_count);
    if (ret != 0) {
        free(lut);
        return ret;
    }

    {
        long offset = 0;
        for (c = 0; c < n_channels; ++c) {
            wav2_decode(out + offset, nx[c], 1, ny[c], nx[c], max_value);
            offset += (long)nx[c] * ny[c];
        }
    }

    {
        long i;
        for (i = 0; i < out_count; ++i) out[i] = lut[out[i]];
    }

    free(lut);
    return 0;
}
