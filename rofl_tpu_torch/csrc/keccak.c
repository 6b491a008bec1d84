/* Keccak-f[1600] and the STROBE-128 absorb / overwrite / squeeze loops of
 * the host Merlin transcripts (rofl_tpu_torch/spec/merlin.py), and the bulk
 * loops of Transcript.append_messages and .append_labeled_messages. A sponge
 * is sequential, so the host runs it in native code; the batched transcripts
 * of the Sigma-protocols run on the device instead (ops/keccak_batch.py).
 *
 * The port's own copy of rofl_tpu/utils/native/keccak.c. Built at first use
 * with the system cc (cc -O3 -shared -fPIC) by rofl_tpu_torch/utils/native.py
 * and loaded with ctypes; the pure-Python loops in spec/merlin.py are the
 * functions the tests hold it against.
 */

#include <stdint.h>
#include <string.h>

#define ROL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

void keccak_f1600(uint8_t state[200]) {
  uint64_t A[5][5], B[5][5], C[5], D[5];
  int x, y, r;
  for (x = 0; x < 5; x++)
    for (y = 0; y < 5; y++)
      memcpy(&A[x][y], state + 8 * (x + 5 * y), 8);

  for (r = 0; r < 24; r++) {
    for (x = 0; x < 5; x++)
      C[x] = A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4];
    for (x = 0; x < 5; x++)
      D[x] = C[(x + 4) % 5] ^ ROL64(C[(x + 1) % 5], 1);
    for (x = 0; x < 5; x++)
      for (y = 0; y < 5; y++)
        A[x][y] ^= D[x];
    for (x = 0; x < 5; x++)
      for (y = 0; y < 5; y++) {
        int rot = RHO[x][y];
        B[y][(2 * x + 3 * y) % 5] = rot ? ROL64(A[x][y], rot) : A[x][y];
      }
    for (x = 0; x < 5; x++)
      for (y = 0; y < 5; y++)
        A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y]);
    A[0][0] ^= RC[r];
  }

  for (x = 0; x < 5; x++)
    for (y = 0; y < 5; y++)
      memcpy(state + 8 * (x + 5 * y), &A[x][y], 8);
}

/* STROBE absorb loop: XOR data into state from pos, running the STROBE-128
 * F permutation (with pos_begin/flag padding) at each rate boundary.
 * Returns the new pos; *pos_begin_io is updated on each F. */
int strobe_absorb(uint8_t state[200], int pos, int *pos_begin_io,
                  const uint8_t *data, long len, int strobe_r) {
  long i;
  for (i = 0; i < len; i++) {
    state[pos] ^= data[i];
    pos++;
    if (pos == strobe_r) {
      state[pos] ^= (uint8_t)(*pos_begin_io);
      state[pos + 1] ^= 0x04;
      state[strobe_r + 1] ^= 0x80;
      keccak_f1600(state);
      pos = 0;
      *pos_begin_io = 0;
    }
  }
  return pos;
}

/* STROBE overwrite loop (KEY op). */
int strobe_overwrite(uint8_t state[200], int pos, int *pos_begin_io,
                     const uint8_t *data, long len, int strobe_r) {
  long i;
  for (i = 0; i < len; i++) {
    state[pos] = data[i];
    pos++;
    if (pos == strobe_r) {
      state[pos] ^= (uint8_t)(*pos_begin_io);
      state[pos + 1] ^= 0x04;
      state[strobe_r + 1] ^= 0x80;
      keccak_f1600(state);
      pos = 0;
      *pos_begin_io = 0;
    }
  }
  return pos;
}

/* STROBE squeeze (PRF op): read+zero state bytes. */
int strobe_squeeze(uint8_t state[200], int pos, int *pos_begin_io,
                   uint8_t *out, long len, int strobe_r) {
  long i;
  for (i = 0; i < len; i++) {
    out[i] = state[pos];
    state[pos] = 0;
    pos++;
    if (pos == strobe_r) {
      state[pos] ^= (uint8_t)(*pos_begin_io);
      state[pos + 1] ^= 0x04;
      state[strobe_r + 1] ^= 0x80;
      keccak_f1600(state);
      pos = 0;
      *pos_begin_io = 0;
    }
  }
  return pos;
}

/* Bulk Merlin append_message loop: for each of `count` fixed-size
 * messages, run the three STROBE ops merlin's append_message performs —
 * meta_ad(label, more=false), meta_ad(u32le(msg_len), more=true),
 * ad(msg, more=false) — entirely in C (one ctypes call per transcript
 * instead of 3 per message; the verifier replays 2^16 point absorbs).
 * Message i goes under the label at labels + i * label_stride: stride 0
 * for one label for all, label_len for a label of its own each.
 * Flags: meta_ad = M|A = 0x12, ad = A = 0x02; neither forces F. */
static int absorb_msgs(uint8_t state[200], int pos, int *pos_begin_io,
                       const uint8_t *labels, long label_len, long label_stride,
                       const uint8_t *msgs, long msg_len, long count,
                       int strobe_r) {
  long i;
  uint8_t hdr[2];
  uint8_t len_le[4];
  len_le[0] = (uint8_t)(msg_len & 0xff);
  len_le[1] = (uint8_t)((msg_len >> 8) & 0xff);
  len_le[2] = (uint8_t)((msg_len >> 16) & 0xff);
  len_le[3] = (uint8_t)((msg_len >> 24) & 0xff);
  for (i = 0; i < count; i++) {
    /* begin_op(M|A): absorb [old_pos_begin, flags] */
    hdr[0] = (uint8_t)(*pos_begin_io);
    hdr[1] = 0x12;
    *pos_begin_io = pos + 1;
    pos = strobe_absorb(state, pos, pos_begin_io, hdr, 2, strobe_r);
    pos = strobe_absorb(state, pos, pos_begin_io, labels + i * label_stride,
                        label_len, strobe_r);
    /* meta_ad(len, more=true): plain absorb, no new op */
    pos = strobe_absorb(state, pos, pos_begin_io, len_le, 4, strobe_r);
    /* begin_op(A) + message */
    hdr[0] = (uint8_t)(*pos_begin_io);
    hdr[1] = 0x02;
    *pos_begin_io = pos + 1;
    pos = strobe_absorb(state, pos, pos_begin_io, hdr, 2, strobe_r);
    pos = strobe_absorb(state, pos, pos_begin_io, msgs + i * msg_len,
                        msg_len, strobe_r);
  }
  return pos;
}

/* `count` messages, all under one label (Transcript.append_messages). */
int merlin_absorb_msgs(uint8_t state[200], int pos, int *pos_begin_io,
                       const uint8_t *label, long label_len,
                       const uint8_t *msgs, long msg_len, long count,
                       int strobe_r) {
  return absorb_msgs(state, pos, pos_begin_io, label, label_len, 0, msgs,
                     msg_len, count, strobe_r);
}

/* `count` messages, message i under the i-th label_len-byte label of
 * `labels` (Transcript.append_labeled_messages: the compressed rand proof
 * absorbs each commitment under a 3-byte label of its own). */
int merlin_absorb_labeled_msgs(uint8_t state[200], int pos, int *pos_begin_io,
                               const uint8_t *labels, long label_len,
                               const uint8_t *msgs, long msg_len, long count,
                               int strobe_r) {
  return absorb_msgs(state, pos, pos_begin_io, labels, label_len, label_len,
                     msgs, msg_len, count, strobe_r);
}
