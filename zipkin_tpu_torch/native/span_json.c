/* Fast columnar decoder for Zipkin v2 JSON span arrays.
 *
 * The TPU-native analog of the reference's hand-rolled zero-copy codec
 * tier (zipkin2/internal/ReadBuffer.java + V2SpanReader): the generic
 * python json module tops out around 30k spans/s/core, far below the
 * >=125k spans/s/chip ingest target, so the hot path parses straight
 * from the wire bytes into the struct-of-arrays layout the device batch
 * wants - no intermediate objects, strings returned as (offset, length)
 * slices into the input buffer for host-side interning.
 *
 * Scope: exactly the fields the aggregation tier consumes. Unknown keys
 * are skipped structurally (objects/arrays/strings/numbers), so any
 * valid v2 payload parses. On any malformed input the decoder returns a
 * negative error and the caller falls back to the python codec, which
 * produces the authoritative error message.
 *
 * Built with: cc -O2 -fPIC -shared (see build.py); called via ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef struct {
  /* per-span columns, caller-allocated with capacity `cap` */
  uint32_t *tl0, *tl1;   /* trace id low-64 lanes */
  uint32_t *th0, *th1;   /* trace id high-64 lanes (0 for 64-bit ids) */
  uint32_t *s0, *s1;     /* span id lanes */
  uint32_t *p0, *p1;     /* parent id lanes */
  uint8_t  *shared_flag;
  uint8_t  *kind;        /* 0 none, 1 client, 2 server, 3 producer, 4 consumer */
  uint8_t  *err;         /* tags contain an "error" key */
  uint8_t  *has_dur;
  uint64_t *ts_us;
  uint32_t *dur_us;      /* clamped to u32 */
  uint8_t  *debug_flag;
  /* string slices into the input buffer: offset/length pairs */
  uint32_t *svc_off, *svc_len;
  uint32_t *rsvc_off, *rsvc_len;
  uint32_t *name_off, *name_len;
  /* byte extent of each span's own JSON object in the input: lets the
   * caller re-decode an exact sampled subset at full fidelity (tags,
   * annotations) without re-parsing the whole payload */
  uint32_t *span_off, *span_len;
} columns_t;

typedef struct {
  const uint8_t *buf;
  size_t pos, n;
} cursor_t;

#define ERR_TRUNC  (-1)
#define ERR_SYNTAX (-2)
#define ERR_CAP    (-3)

static void skip_ws(cursor_t *c) {
  while (c->pos < c->n) {
    uint8_t b = c->buf[c->pos];
    if (b == ' ' || b == '\t' || b == '\n' || b == '\r') c->pos++;
    else break;
  }
}

static int skip_string(cursor_t *c) { /* cursor at opening quote */
  if (c->buf[c->pos] != '"') return ERR_SYNTAX;
  c->pos++;
  while (c->pos < c->n) {
    uint8_t b = c->buf[c->pos];
    if (b == '\\') { c->pos += 2; continue; }
    if (b == '"') { c->pos++; return 0; }
    c->pos++;
  }
  return ERR_TRUNC;
}

/* string contents as a raw slice (escapes NOT decoded: service/span names
 * with escapes are rare; the python fallback below handles them) */
static int read_string_slice(cursor_t *c, uint32_t *off, uint32_t *len,
                             int *has_escape) {
  if (c->pos >= c->n || c->buf[c->pos] != '"') return ERR_SYNTAX;
  c->pos++;
  size_t start = c->pos;
  *has_escape = 0;
  while (c->pos < c->n) {
    uint8_t b = c->buf[c->pos];
    if (b == '\\') { *has_escape = 1; c->pos += 2; continue; }
    if (b == '"') {
      *off = (uint32_t)start;
      *len = (uint32_t)(c->pos - start);
      c->pos++;
      return 0;
    }
    c->pos++;
  }
  return ERR_TRUNC;
}

static int skip_value(cursor_t *c);

static int skip_object(cursor_t *c) {
  c->pos++; /* '{' */
  skip_ws(c);
  if (c->pos < c->n && c->buf[c->pos] == '}') { c->pos++; return 0; }
  for (;;) {
    skip_ws(c);
    int rc = skip_string(c); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n || c->buf[c->pos] != ':') return ERR_SYNTAX;
    c->pos++;
    rc = skip_value(c); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n) return ERR_TRUNC;
    if (c->buf[c->pos] == ',') { c->pos++; continue; }
    if (c->buf[c->pos] == '}') { c->pos++; return 0; }
    return ERR_SYNTAX;
  }
}

static int skip_array(cursor_t *c) {
  c->pos++; /* '[' */
  skip_ws(c);
  if (c->pos < c->n && c->buf[c->pos] == ']') { c->pos++; return 0; }
  for (;;) {
    int rc = skip_value(c); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n) return ERR_TRUNC;
    if (c->buf[c->pos] == ',') { c->pos++; continue; }
    if (c->buf[c->pos] == ']') { c->pos++; return 0; }
    return ERR_SYNTAX;
  }
}

static int skip_value(cursor_t *c) {
  skip_ws(c);
  if (c->pos >= c->n) return ERR_TRUNC;
  uint8_t b = c->buf[c->pos];
  if (b == '"') return skip_string(c);
  if (b == '{') return skip_object(c);
  if (b == '[') return skip_array(c);
  /* number / true / false / null */
  while (c->pos < c->n) {
    b = c->buf[c->pos];
    if (b == ',' || b == '}' || b == ']' || b == ' ' || b == '\t' ||
        b == '\n' || b == '\r')
      return 0;
    c->pos++;
  }
  return 0;
}

static int hex_val(uint8_t b) {
  if (b >= '0' && b <= '9') return b - '0';
  if (b >= 'a' && b <= 'f') return b - 'a' + 10;
  if (b >= 'A' && b <= 'F') return b - 'A' + 10;
  return -1;
}

/* parse a quoted hex id of up to 32 chars into hi64/lo64 */
static int read_hex_id(cursor_t *c, uint64_t *hi, uint64_t *lo) {
  uint32_t off, len; int esc;
  int rc = read_string_slice(c, &off, &len, &esc);
  if (rc) return rc;
  if (esc || len == 0 || len > 32) return ERR_SYNTAX;
  uint64_t h = 0, l = 0;
  const uint8_t *p = c->buf + off;
  uint32_t lo_start = len > 16 ? len - 16 : 0;
  for (uint32_t i = 0; i < len; i++) {
    int v = hex_val(p[i]);
    if (v < 0) return ERR_SYNTAX;
    if (i < lo_start) h = (h << 4) | (uint64_t)v;
    else l = (l << 4) | (uint64_t)v;
  }
  *hi = h; *lo = l;
  return 0;
}

static int read_u64(cursor_t *c, uint64_t *out) {
  skip_ws(c);
  uint64_t v = 0;
  int any = 0;
  while (c->pos < c->n) {
    uint8_t b = c->buf[c->pos];
    if (b >= '0' && b <= '9') {
      v = v * 10 + (uint64_t)(b - '0');
      any = 1;
      c->pos++;
    } else if (any && (b == '.' || b == 'e' || b == 'E')) {
      /* fractional timestamps are out of spec; bail to python */
      return ERR_SYNTAX;
    } else break;
  }
  if (!any) return ERR_SYNTAX;
  *out = v;
  return 0;
}

static int key_is(const uint8_t *buf, uint32_t off, uint32_t len,
                  const char *name) {
  size_t n = strlen(name);
  return len == n && memcmp(buf + off, name, n) == 0;
}

/* parse an endpoint object; returns serviceName slice (len 0 if absent) */
static int read_endpoint(cursor_t *c, uint32_t *soff, uint32_t *slen) {
  *soff = 0; *slen = 0;
  skip_ws(c);
  if (c->pos + 4 <= c->n && memcmp(c->buf + c->pos, "null", 4) == 0) {
    c->pos += 4;
    return 0;
  }
  if (c->pos >= c->n || c->buf[c->pos] != '{') return ERR_SYNTAX;
  c->pos++;
  skip_ws(c);
  if (c->pos < c->n && c->buf[c->pos] == '}') { c->pos++; return 0; }
  for (;;) {
    skip_ws(c);
    uint32_t koff, klen; int esc;
    int rc = read_string_slice(c, &koff, &klen, &esc); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n || c->buf[c->pos] != ':') return ERR_SYNTAX;
    c->pos++;
    skip_ws(c);
    if (!esc && key_is(c->buf, koff, klen, "serviceName") &&
        c->pos < c->n && c->buf[c->pos] == '"') {
      int esc2;
      rc = read_string_slice(c, soff, slen, &esc2); if (rc) return rc;
      if (esc2) return ERR_SYNTAX; /* escaped service names: python path */
    } else {
      rc = skip_value(c); if (rc) return rc;
    }
    skip_ws(c);
    if (c->pos >= c->n) return ERR_TRUNC;
    if (c->buf[c->pos] == ',') { c->pos++; continue; }
    if (c->buf[c->pos] == '}') { c->pos++; return 0; }
    return ERR_SYNTAX;
  }
}

/* tags object: only "error"-key presence matters for the columns */
static int read_tags(cursor_t *c, uint8_t *has_error) {
  skip_ws(c);
  if (c->pos >= c->n || c->buf[c->pos] != '{') return ERR_SYNTAX;
  c->pos++;
  skip_ws(c);
  if (c->pos < c->n && c->buf[c->pos] == '}') { c->pos++; return 0; }
  for (;;) {
    skip_ws(c);
    uint32_t koff, klen; int esc;
    int rc = read_string_slice(c, &koff, &klen, &esc); if (rc) return rc;
    if (!esc && key_is(c->buf, koff, klen, "error")) *has_error = 1;
    skip_ws(c);
    if (c->pos >= c->n || c->buf[c->pos] != ':') return ERR_SYNTAX;
    c->pos++;
    rc = skip_value(c); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n) return ERR_TRUNC;
    if (c->buf[c->pos] == ',') { c->pos++; continue; }
    if (c->buf[c->pos] == '}') { c->pos++; return 0; }
    return ERR_SYNTAX;
  }
}

static int read_kind(cursor_t *c, uint8_t *kind) {
  uint32_t off, len; int esc;
  int rc = read_string_slice(c, &off, &len, &esc); if (rc) return rc;
  if (esc) return ERR_SYNTAX;
  if (key_is(c->buf, off, len, "CLIENT")) *kind = 1;
  else if (key_is(c->buf, off, len, "SERVER")) *kind = 2;
  else if (key_is(c->buf, off, len, "PRODUCER")) *kind = 3;
  else if (key_is(c->buf, off, len, "CONSUMER")) *kind = 4;
  else return ERR_SYNTAX; /* unknown kind: python path decides */
  return 0;
}

static int read_bool(cursor_t *c, uint8_t *out) {
  skip_ws(c);
  if (c->pos + 4 <= c->n && memcmp(c->buf + c->pos, "true", 4) == 0) {
    *out = 1; c->pos += 4; return 0;
  }
  if (c->pos + 5 <= c->n && memcmp(c->buf + c->pos, "false", 5) == 0) {
    *out = 0; c->pos += 5; return 0;
  }
  return ERR_SYNTAX;
}

static int parse_span(cursor_t *c, columns_t *cols, long i) {
  skip_ws(c);
  if (c->pos >= c->n || c->buf[c->pos] != '{') return ERR_SYNTAX;
  cols->span_off[i] = (uint32_t)c->pos;
  c->pos++;
  skip_ws(c);
  if (c->pos < c->n && c->buf[c->pos] == '}') return ERR_SYNTAX; /* id req */
  int have_trace = 0, have_id = 0;
  for (;;) {
    skip_ws(c);
    uint32_t koff, klen; int esc;
    int rc = read_string_slice(c, &koff, &klen, &esc); if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n || c->buf[c->pos] != ':') return ERR_SYNTAX;
    c->pos++;
    skip_ws(c);
    const uint8_t *b = c->buf;
    if (esc) { rc = skip_value(c); }
    else if (key_is(b, koff, klen, "traceId")) {
      uint64_t hi, lo;
      rc = read_hex_id(c, &hi, &lo);
      cols->th0[i] = (uint32_t)hi; cols->th1[i] = (uint32_t)(hi >> 32);
      cols->tl0[i] = (uint32_t)lo; cols->tl1[i] = (uint32_t)(lo >> 32);
      have_trace = 1;
    } else if (key_is(b, koff, klen, "id")) {
      uint64_t hi, lo;
      rc = read_hex_id(c, &hi, &lo);
      if (!rc && hi) rc = ERR_SYNTAX; /* span id must be 64-bit */
      cols->s0[i] = (uint32_t)lo; cols->s1[i] = (uint32_t)(lo >> 32);
      have_id = 1;
    } else if (key_is(b, koff, klen, "parentId")) {
      if (c->pos + 4 <= c->n && memcmp(b + c->pos, "null", 4) == 0) {
        c->pos += 4; rc = 0;
      } else {
        uint64_t hi, lo;
        rc = read_hex_id(c, &hi, &lo);
        if (!rc && hi) rc = ERR_SYNTAX;
        cols->p0[i] = (uint32_t)lo; cols->p1[i] = (uint32_t)(lo >> 32);
      }
    } else if (key_is(b, koff, klen, "name")) {
      int esc2;
      rc = read_string_slice(c, &cols->name_off[i], &cols->name_len[i], &esc2);
      if (!rc && esc2) rc = ERR_SYNTAX;
    } else if (key_is(b, koff, klen, "kind")) {
      rc = read_kind(c, &cols->kind[i]);
    } else if (key_is(b, koff, klen, "timestamp")) {
      rc = read_u64(c, &cols->ts_us[i]);
    } else if (key_is(b, koff, klen, "duration")) {
      uint64_t d;
      rc = read_u64(c, &d);
      cols->dur_us[i] = d > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)d;
      cols->has_dur[i] = 1;
    } else if (key_is(b, koff, klen, "localEndpoint")) {
      rc = read_endpoint(c, &cols->svc_off[i], &cols->svc_len[i]);
    } else if (key_is(b, koff, klen, "remoteEndpoint")) {
      rc = read_endpoint(c, &cols->rsvc_off[i], &cols->rsvc_len[i]);
    } else if (key_is(b, koff, klen, "tags")) {
      rc = read_tags(c, &cols->err[i]);
    } else if (key_is(b, koff, klen, "shared")) {
      rc = read_bool(c, &cols->shared_flag[i]);
    } else if (key_is(b, koff, klen, "debug")) {
      rc = read_bool(c, &cols->debug_flag[i]);
    } else {
      rc = skip_value(c);
    }
    if (rc) return rc;
    skip_ws(c);
    if (c->pos >= c->n) return ERR_TRUNC;
    if (c->buf[c->pos] == ',') { c->pos++; continue; }
    if (c->buf[c->pos] == '}') { c->pos++; break; }
    return ERR_SYNTAX;
  }
  cols->span_len[i] = (uint32_t)(c->pos - cols->span_off[i]);
  return (have_trace && have_id) ? 0 : ERR_SYNTAX;
}

/* entry point: parse a JSON array of spans into the columns.
 * Returns span count >= 0, or a negative error code. */
long zt_parse_spans(const uint8_t *buf, size_t n, long cap,
                    uint32_t *tl0, uint32_t *tl1, uint32_t *th0, uint32_t *th1,
                    uint32_t *s0, uint32_t *s1, uint32_t *p0, uint32_t *p1,
                    uint8_t *shared_flag, uint8_t *kind, uint8_t *err,
                    uint8_t *has_dur, uint64_t *ts_us, uint32_t *dur_us,
                    uint8_t *debug_flag,
                    uint32_t *svc_off, uint32_t *svc_len,
                    uint32_t *rsvc_off, uint32_t *rsvc_len,
                    uint32_t *name_off, uint32_t *name_len,
                    uint32_t *span_off, uint32_t *span_len) {
  columns_t cols = {
    tl0, tl1, th0, th1, s0, s1, p0, p1, shared_flag, kind, err, has_dur,
    ts_us, dur_us, debug_flag, svc_off, svc_len, rsvc_off, rsvc_len,
    name_off, name_len, span_off, span_len,
  };
  cursor_t c = {buf, 0, n};
  skip_ws(&c);
  if (c.pos >= c.n || c.buf[c.pos] != '[') return ERR_SYNTAX;
  c.pos++;
  skip_ws(&c);
  long count = 0;
  if (c.pos < c.n && c.buf[c.pos] == ']') return 0;
  for (;;) {
    if (count >= cap) return ERR_CAP;
    int rc = parse_span(&c, &cols, count);
    if (rc) return rc;
    count++;
    skip_ws(&c);
    if (c.pos >= c.n) return ERR_TRUNC;
    if (c.buf[c.pos] == ',') { c.pos++; continue; }
    if (c.buf[c.pos] == ']') return count;
    return ERR_SYNTAX;
  }
}

/* ---------------- native vocab: interning at parse time ----------------
 *
 * The Python interning loop costs ~2.7us/span - the single largest host
 * cost at line rate - so the parser can intern service names, span names
 * and (service, name) key pairs itself. Ids are assigned sequentially in
 * first-seen order; the Python Vocab mirrors them by draining the
 * insertion journal after each parse (ids must match exactly, which the
 * wrapper asserts).
 *
 * ASCII-lowercase normalization matches the model's .lower() for ASCII;
 * non-ASCII bytes pass through unchanged (documented deviation).
 */

#include <stdlib.h>

typedef struct {
  uint32_t *hash, *off, *len, *id; /* open-addressing slots, 0 id = empty */
  size_t slots;                    /* power of two */
  uint8_t *arena;
  size_t arena_cap, arena_used;
  uint32_t next_id, max_ids;
  uint32_t *journal;               /* arena offsets in insertion order */
  uint32_t *journal_len;
  uint32_t journal_count, drained;
  uint32_t overflow;
} strtab_t;

typedef struct {
  uint64_t *key; uint32_t *id;
  size_t slots;
  uint32_t next_id, max_ids;
  uint64_t *journal;
  uint32_t journal_count, drained;
  uint32_t overflow;
} pairtab_t;

typedef struct {
  strtab_t services, names;
  pairtab_t pairs;
} vocab_t;

static size_t pow2_at_least(size_t n) {
  size_t p = 64;
  while (p < n) p <<= 1;
  return p;
}

static int strtab_init(strtab_t *t, uint32_t max_ids) {
  t->slots = pow2_at_least((size_t)max_ids * 4);
  t->hash = calloc(t->slots, 4);
  t->off = calloc(t->slots, 4);
  t->len = calloc(t->slots, 4);
  t->id = calloc(t->slots, 4);
  t->arena_cap = (size_t)max_ids * 64 + 4096;
  t->arena = malloc(t->arena_cap);
  t->arena_used = 0;
  t->next_id = 1;
  t->max_ids = max_ids;
  t->journal = calloc(max_ids + 1, 4);
  t->journal_len = calloc(max_ids + 1, 4);
  t->journal_count = t->drained = 0;
  t->overflow = 0;
  return (t->hash && t->off && t->len && t->id && t->arena && t->journal &&
          t->journal_len) ? 0 : -1;
}

static uint32_t fnv1a(const uint8_t *s, uint32_t len) {
  uint32_t h = 2166136261u;
  for (uint32_t i = 0; i < len; i++) { h ^= s[i]; h *= 16777619u; }
  return h ? h : 1u;
}

static uint8_t lower_ascii(uint8_t b) {
  return (b >= 'A' && b <= 'Z') ? (uint8_t)(b + 32) : b;
}

/* intern the ASCII-lowercased string; 0 on overflow */
static uint32_t strtab_intern(strtab_t *t, const uint8_t *s, uint32_t len) {
  uint8_t tmp[512];
  if (len == 0) return 0;
  if (len > sizeof(tmp)) { t->overflow++; return 0; }
  for (uint32_t i = 0; i < len; i++) tmp[i] = lower_ascii(s[i]);
  uint32_t h = fnv1a(tmp, len);
  size_t mask = t->slots - 1;
  size_t slot = h & mask;
  for (;;) {
    if (t->id[slot] == 0) break; /* empty */
    if (t->hash[slot] == h && t->len[slot] == len &&
        memcmp(t->arena + t->off[slot], tmp, len) == 0)
      return t->id[slot];
    slot = (slot + 1) & mask;
  }
  if (t->next_id > t->max_ids || t->arena_used + len > t->arena_cap) {
    t->overflow++;
    return 0;
  }
  memcpy(t->arena + t->arena_used, tmp, len);
  t->hash[slot] = h;
  t->off[slot] = (uint32_t)t->arena_used;
  t->len[slot] = len;
  t->id[slot] = t->next_id;
  t->journal[t->journal_count] = (uint32_t)t->arena_used;
  t->journal_len[t->journal_count] = len;
  t->journal_count++;
  t->arena_used += len;
  return t->next_id++;
}

static int pairtab_init(pairtab_t *t, uint32_t max_ids) {
  t->slots = pow2_at_least((size_t)max_ids * 4);
  t->key = calloc(t->slots, 8);
  t->id = calloc(t->slots, 4);
  t->next_id = 1;
  t->max_ids = max_ids;
  t->journal = calloc(max_ids + 1, 8);
  t->journal_count = t->drained = 0;
  t->overflow = 0;
  return (t->key && t->id && t->journal) ? 0 : -1;
}

static uint32_t pairtab_find(const pairtab_t *t, uint32_t a, uint32_t b) {
  uint64_t k = ((uint64_t)a << 32) | b | 0x8000000000000000ull;
  size_t mask = t->slots - 1;
  uint64_t h = k * 0x9E3779B97F4A7C15ull;
  size_t slot = (size_t)(h >> 32) & mask;
  for (;;) {
    if (t->id[slot] == 0) return 0;
    if (t->key[slot] == k) return t->id[slot];
    slot = (slot + 1) & mask;
  }
}

/* raw probe+insert: NO derived insertions, so replay paths can
   reproduce a historical id assignment verbatim whatever interning
   rules the writing build used (position-faithful). count_overflow=0
   for the derived catch-all pre-reserve, so one rejected intern counts
   exactly once — matching the Python interner's accounting. */
static uint32_t pairtab_put(pairtab_t *t, uint32_t a, uint32_t b,
                            int count_overflow) {
  uint64_t k = ((uint64_t)a << 32) | b | 0x8000000000000000ull; /* nonzero */
  size_t mask = t->slots - 1;
  uint64_t h = k * 0x9E3779B97F4A7C15ull;
  size_t slot = (size_t)(h >> 32) & mask;
  for (;;) {
    if (t->id[slot] == 0) break;
    if (t->key[slot] == k) return t->id[slot];
    slot = (slot + 1) & mask;
  }
  if (t->next_id > t->max_ids) {
    if (count_overflow) t->overflow++;
    return 0;
  }
  t->key[slot] = k;
  t->id[slot] = t->next_id;
  t->journal[t->journal_count++] = ((uint64_t)a << 32) | b;
  return t->next_id++;
}

static uint32_t pairtab_intern(pairtab_t *t, uint32_t a, uint32_t b) {
  uint32_t got = pairtab_find(t, a, b);
  if (got) return got;
  /* pre-reserve the per-service catch-all (a, 0) BEFORE the named
     pair — the Python interner does the same, in the same order, so
     the two id streams stay identical. Past capacity, span-name churn
     then aggregates under its SERVICE's catch-all row instead of the
     global unknown row 0 (VERDICT r3 order 5). service 0 is the
     global unknown itself: no catch-all (a shadow (0,0) row would
     hijack unknown-service mass from row 0). */
  if (b != 0 && a != 0) pairtab_put(t, a, 0, 0);
  got = pairtab_put(t, a, b, 1);
  if (got) return got;
  if (b != 0 && a != 0) return pairtab_find(t, a, 0);
  return 0;
}

void *zt_vocab_new(uint32_t max_services, uint32_t max_names,
                   uint32_t max_keys) {
  vocab_t *v = calloc(1, sizeof(vocab_t));
  if (!v) return NULL;
  if (strtab_init(&v->services, max_services) ||
      strtab_init(&v->names, max_names) || pairtab_init(&v->pairs, max_keys)) {
    return NULL;
  }
  return v;
}

void zt_vocab_free(void *vp) {
  vocab_t *v = (vocab_t *)vp;
  if (!v) return;
  free(v->services.hash); free(v->services.off); free(v->services.len);
  free(v->services.id); free(v->services.arena); free(v->services.journal);
  free(v->services.journal_len);
  free(v->names.hash); free(v->names.off); free(v->names.len);
  free(v->names.id); free(v->names.arena); free(v->names.journal);
  free(v->names.journal_len);
  free(v->pairs.key); free(v->pairs.id); free(v->pairs.journal);
  free(v);
}

/* journal draining: returns count of new entries since the last drain;
 * table 0 = services, 1 = names. Strings are copied into out (layout:
 * u32 len + bytes, packed), which must hold out_cap bytes. */
long zt_vocab_drain_strings(void *vp, int table, uint8_t *out,
                            size_t out_cap) {
  vocab_t *v = (vocab_t *)vp;
  strtab_t *t = table == 0 ? &v->services : &v->names;
  size_t pos = 0;
  long produced = 0;
  while (t->drained < t->journal_count) {
    uint32_t off = t->journal[t->drained];
    uint32_t len = t->journal_len[t->drained];
    if (pos + 4 + len > out_cap) break;
    memcpy(out + pos, &len, 4);
    memcpy(out + pos + 4, t->arena + off, len);
    pos += 4 + len;
    t->drained++;
    produced++;
  }
  return produced;
}

long zt_vocab_drain_pairs(void *vp, uint64_t *out, long max) {
  vocab_t *v = (vocab_t *)vp;
  pairtab_t *t = &v->pairs;
  long produced = 0;
  while (t->drained < t->journal_count && produced < max) {
    out[produced++] = t->journal[t->drained++];
  }
  return produced;
}

long zt_vocab_overflow(void *vp) {
  vocab_t *v = (vocab_t *)vp;
  return (long)(v->services.overflow + v->names.overflow + v->pairs.overflow);
}

/* parse + intern in one pass: same as zt_parse_spans plus id columns.
 * vocab may be NULL (ids left zero). */
long zt_parse_spans_interned(
    const uint8_t *buf, size_t n, long cap, void *vocabp,
    uint32_t *tl0, uint32_t *tl1, uint32_t *th0, uint32_t *th1,
    uint32_t *s0, uint32_t *s1, uint32_t *p0, uint32_t *p1,
    uint8_t *shared_flag, uint8_t *kind, uint8_t *err,
    uint8_t *has_dur, uint64_t *ts_us, uint32_t *dur_us, uint8_t *debug_flag,
    uint32_t *svc_off, uint32_t *svc_len,
    uint32_t *rsvc_off, uint32_t *rsvc_len,
    uint32_t *name_off, uint32_t *name_len,
    uint32_t *span_off, uint32_t *span_len,
    int32_t *svc_id, int32_t *rsvc_id, int32_t *name_id, int32_t *key_id) {
  long count = zt_parse_spans(buf, n, cap, tl0, tl1, th0, th1, s0, s1, p0, p1,
                              shared_flag, kind, err, has_dur, ts_us, dur_us,
                              debug_flag, svc_off, svc_len, rsvc_off, rsvc_len,
                              name_off, name_len, span_off, span_len);
  if (count <= 0 || vocabp == NULL) return count;
  vocab_t *v = (vocab_t *)vocabp;
  for (long i = 0; i < count; i++) {
    uint32_t sid = strtab_intern(&v->services, buf + svc_off[i], svc_len[i]);
    uint32_t rid = strtab_intern(&v->services, buf + rsvc_off[i], rsvc_len[i]);
    uint32_t nid = strtab_intern(&v->names, buf + name_off[i], name_len[i]);
    svc_id[i] = (int32_t)sid;
    rsvc_id[i] = (int32_t)rid;
    name_id[i] = (int32_t)nid;
    key_id[i] = (int32_t)pairtab_intern(&v->pairs, sid, nid);
  }
  return count;
}

void zt_vocab_counts(void *vp, uint32_t *services, uint32_t *names,
                     uint32_t *pairs) {
  vocab_t *v = (vocab_t *)vp;
  *services = v->services.next_id - 1;
  *names = v->names.next_id - 1;
  *pairs = v->pairs.next_id - 1;
}

/* direct interning entry points (vocab seeding from the python side) */
long zt_intern_service(void *vp, const uint8_t *s, uint32_t len) {
  return (long)strtab_intern(&((vocab_t *)vp)->services, s, len);
}
long zt_intern_name(void *vp, const uint8_t *s, uint32_t len) {
  return (long)strtab_intern(&((vocab_t *)vp)->names, s, len);
}
long zt_intern_pair(void *vp, uint32_t svc, uint32_t name) {
  return (long)pairtab_intern(&((vocab_t *)vp)->pairs, svc, name);
}
/* position-faithful insert for replay (ensure_synced): records the pair
   at the next id with NO catch-all derivation, so a vocabulary written
   by any build — including pre-catch-all layouts — replays to identical
   ids. */
long zt_intern_pair_raw(void *vp, uint32_t svc, uint32_t name) {
  return (long)pairtab_put(&((vocab_t *)vp)->pairs, svc, name, 1);
}

/* ====================================================================
 * proto3 ListOfSpans parser (VERDICT r4 order 6): the binary analog of
 * the JSON columnar parser above, so gRPC/proto3 ingest rides the same
 * line-rate path. Wire layout per zipkin.proto (mirrored by the
 * reference's hand-rolled Proto3Codec — SURVEY.md §2.1): ListOfSpans =
 * repeated Span field 1; Span fields: 1 trace_id bytes(8|16),
 * 2 parent_id bytes(8), 3 id bytes(8), 4 kind enum, 5 name string,
 * 6 timestamp fixed64, 7 duration varint, 8/9 endpoints (1 service
 * string), 10 annotations, 11 tags entries (1 key, 2 value),
 * 12 debug, 13 shared. Anything structurally surprising returns an
 * error so the caller falls back to the strict object codec.
 * ==================================================================== */

typedef struct { const uint8_t *buf; size_t pos, n; } p3cur_t;

static int p3_varint(p3cur_t *c, uint64_t *out) {
  uint64_t v = 0; int shift = 0;
  while (c->pos < c->n && shift < 64) {
    uint8_t b = c->buf[c->pos++];
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = v; return 0; }
    shift += 7;
  }
  return ERR_TRUNC;
}

static int p3_skip(p3cur_t *c, int wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return p3_varint(c, &tmp);
    case 1: if (c->pos + 8 > c->n) return ERR_TRUNC; c->pos += 8; return 0;
    case 2:
      if (p3_varint(c, &tmp)) return ERR_TRUNC;
      if (tmp > c->n - c->pos) return ERR_TRUNC;
      c->pos += (size_t)tmp; return 0;
    case 5: if (c->pos + 4 > c->n) return ERR_TRUNC; c->pos += 4; return 0;
    default: return ERR_SYNTAX; /* groups / reserved: punt to fallback */
  }
}

static uint64_t p3_be64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

/* extract the serviceName slice (field 1) from an Endpoint submessage */
static int p3_endpoint(const uint8_t *buf, size_t off, size_t len,
                       uint32_t *sv_off, uint32_t *sv_len) {
  p3cur_t c = {buf, off, off + len};
  while (c.pos < c.n) {
    uint64_t tag;
    if (p3_varint(&c, &tag)) return ERR_TRUNC;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    if (field == 1 && wire == 2) {
      uint64_t sl;
      if (p3_varint(&c, &sl)) return ERR_TRUNC;
      if (sl > c.n - c.pos) return ERR_TRUNC;
      *sv_off = (uint32_t)c.pos; *sv_len = (uint32_t)sl;
      c.pos += (size_t)sl;
    } else if (p3_skip(&c, wire)) {
      return ERR_SYNTAX;
    }
  }
  return 0;
}

/* tag entry (field 11): key "error" present => err flag */
static int p3_tag_entry(const uint8_t *buf, size_t off, size_t len,
                        uint8_t *err) {
  p3cur_t c = {buf, off, off + len};
  while (c.pos < c.n) {
    uint64_t tag;
    if (p3_varint(&c, &tag)) return ERR_TRUNC;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    if (field == 1 && wire == 2) {
      uint64_t sl;
      if (p3_varint(&c, &sl)) return ERR_TRUNC;
      if (sl > c.n - c.pos) return ERR_TRUNC;
      if (sl == 5 && memcmp(buf + c.pos, "error", 5) == 0) *err = 1;
      c.pos += (size_t)sl;
    } else if (p3_skip(&c, wire)) {
      return ERR_SYNTAX;
    }
  }
  return 0;
}

static int p3_span(const uint8_t *buf, size_t off, size_t len,
                   columns_t *cols, long i) {
  p3cur_t c = {buf, off, off + len};
  int have_trace = 0, have_id = 0;
  cols->span_off[i] = (uint32_t)off;
  cols->span_len[i] = (uint32_t)len;
  while (c.pos < c.n) {
    uint64_t tag;
    if (p3_varint(&c, &tag)) return ERR_TRUNC;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    uint64_t sl = 0;
    size_t soff = 0;
    if (wire == 2) {
      if (p3_varint(&c, &sl)) return ERR_TRUNC;
      if (sl > c.n - c.pos) return ERR_TRUNC;
      soff = c.pos;
      c.pos += (size_t)sl;
    }
    switch (field) {
      case 1: /* trace_id: 16 (128-bit) or 8 (64-bit) bytes */
        if (wire != 2) return ERR_SYNTAX;
        if (sl == 16) {
          uint64_t hi = p3_be64(buf + soff), lo = p3_be64(buf + soff + 8);
          cols->th0[i] = (uint32_t)hi; cols->th1[i] = (uint32_t)(hi >> 32);
          cols->tl0[i] = (uint32_t)lo; cols->tl1[i] = (uint32_t)(lo >> 32);
        } else if (sl == 8) {
          uint64_t lo = p3_be64(buf + soff);
          cols->th0[i] = 0; cols->th1[i] = 0;
          cols->tl0[i] = (uint32_t)lo; cols->tl1[i] = (uint32_t)(lo >> 32);
        } else {
          return ERR_SYNTAX;
        }
        have_trace = 1;
        break;
      case 2: /* parent_id */
        if (wire != 2 || sl != 8) return ERR_SYNTAX;
        {
          uint64_t lo = p3_be64(buf + soff);
          cols->p0[i] = (uint32_t)lo; cols->p1[i] = (uint32_t)(lo >> 32);
        }
        break;
      case 3: /* id */
        if (wire != 2 || sl != 8) return ERR_SYNTAX;
        {
          uint64_t lo = p3_be64(buf + soff);
          cols->s0[i] = (uint32_t)lo; cols->s1[i] = (uint32_t)(lo >> 32);
        }
        have_id = 1;
        break;
      case 4: { /* kind enum (matches internal KIND ids 0..4) */
        if (wire != 0) return ERR_SYNTAX;
        uint64_t k;
        if (p3_varint(&c, &k)) return ERR_TRUNC;
        cols->kind[i] = k <= 4 ? (uint8_t)k : 0;
        break;
      }
      case 5: /* name */
        if (wire != 2) return ERR_SYNTAX;
        cols->name_off[i] = (uint32_t)soff;
        cols->name_len[i] = (uint32_t)sl;
        break;
      case 6: { /* timestamp fixed64 (LE) */
        if (wire != 1) return ERR_SYNTAX;
        if (c.pos + 8 > c.n) return ERR_TRUNC;
        uint64_t v = 0;
        for (int b = 7; b >= 0; b--) v = (v << 8) | buf[c.pos + b];
        cols->ts_us[i] = v;
        c.pos += 8;
        break;
      }
      case 7: { /* duration varint */
        if (wire != 0) return ERR_SYNTAX;
        uint64_t d;
        if (p3_varint(&c, &d)) return ERR_TRUNC;
        if (d > 0) {
          cols->dur_us[i] = d > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)d;
          cols->has_dur[i] = 1;
        }
        break;
      }
      case 8: /* local endpoint */
        if (wire != 2) return ERR_SYNTAX;
        if (p3_endpoint(buf, soff, (size_t)sl,
                        &cols->svc_off[i], &cols->svc_len[i]))
          return ERR_SYNTAX;
        break;
      case 9: /* remote endpoint */
        if (wire != 2) return ERR_SYNTAX;
        if (p3_endpoint(buf, soff, (size_t)sl,
                        &cols->rsvc_off[i], &cols->rsvc_len[i]))
          return ERR_SYNTAX;
        break;
      case 11: /* tag entry: detect "error" */
        if (wire != 2) return ERR_SYNTAX;
        if (p3_tag_entry(buf, soff, (size_t)sl, &cols->err[i]))
          return ERR_SYNTAX;
        break;
      case 12: case 13: { /* debug / shared */
        if (wire != 0) return ERR_SYNTAX;
        uint64_t b;
        if (p3_varint(&c, &b)) return ERR_TRUNC;
        if (field == 12) cols->debug_flag[i] = b ? 1 : 0;
        else cols->shared_flag[i] = b ? 1 : 0;
        break;
      }
      default:
        if (wire != 2 && p3_skip(&c, wire)) return ERR_SYNTAX;
        break; /* wire==2 slices were consumed above */
    }
  }
  return (have_trace && have_id) ? 0 : ERR_SYNTAX;
}

long zt_parse_proto3(const uint8_t *buf, size_t n, long cap,
                     uint32_t *tl0, uint32_t *tl1, uint32_t *th0,
                     uint32_t *th1, uint32_t *s0, uint32_t *s1,
                     uint32_t *p0, uint32_t *p1, uint8_t *shared_flag,
                     uint8_t *kind, uint8_t *err, uint8_t *has_dur,
                     uint64_t *ts_us, uint32_t *dur_us, uint8_t *debug_flag,
                     uint32_t *svc_off, uint32_t *svc_len,
                     uint32_t *rsvc_off, uint32_t *rsvc_len,
                     uint32_t *name_off, uint32_t *name_len,
                     uint32_t *span_off, uint32_t *span_len) {
  columns_t cols = {
    tl0, tl1, th0, th1, s0, s1, p0, p1, shared_flag, kind, err, has_dur,
    ts_us, dur_us, debug_flag, svc_off, svc_len, rsvc_off, rsvc_len,
    name_off, name_len, span_off, span_len,
  };
  p3cur_t c = {buf, 0, n};
  long i = 0;
  while (c.pos < c.n) {
    uint64_t tag;
    if (p3_varint(&c, &tag)) return ERR_TRUNC;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    if (field != 1 || wire != 2) return ERR_SYNTAX;
    uint64_t sl;
    if (p3_varint(&c, &sl)) return ERR_TRUNC;
    if (sl > c.n - c.pos) return ERR_TRUNC;
    if (i >= cap) return ERR_CAP;
    int rc = p3_span(buf, c.pos, (size_t)sl, &cols, i);
    if (rc) return rc;
    c.pos += (size_t)sl;
    i++;
  }
  return i;
}

long zt_parse_proto3_interned(
    const uint8_t *buf, size_t n, long cap, void *vocabp,
    uint32_t *tl0, uint32_t *tl1, uint32_t *th0, uint32_t *th1,
    uint32_t *s0, uint32_t *s1, uint32_t *p0, uint32_t *p1,
    uint8_t *shared_flag, uint8_t *kind, uint8_t *err,
    uint8_t *has_dur, uint64_t *ts_us, uint32_t *dur_us, uint8_t *debug_flag,
    uint32_t *svc_off, uint32_t *svc_len,
    uint32_t *rsvc_off, uint32_t *rsvc_len,
    uint32_t *name_off, uint32_t *name_len,
    uint32_t *span_off, uint32_t *span_len,
    int32_t *svc_id, int32_t *rsvc_id, int32_t *name_id, int32_t *key_id) {
  long count = zt_parse_proto3(buf, n, cap, tl0, tl1, th0, th1, s0, s1,
                               p0, p1, shared_flag, kind, err, has_dur,
                               ts_us, dur_us, debug_flag, svc_off, svc_len,
                               rsvc_off, rsvc_len, name_off, name_len,
                               span_off, span_len);
  if (count < 0 || !vocabp) return count;
  vocab_t *v = (vocab_t *)vocabp;
  for (long i = 0; i < count; i++) {
    uint32_t sid = strtab_intern(&v->services, buf + svc_off[i], svc_len[i]);
    uint32_t rid = strtab_intern(&v->services, buf + rsvc_off[i], rsvc_len[i]);
    uint32_t nid = strtab_intern(&v->names, buf + name_off[i], name_len[i]);
    svc_id[i] = (int32_t)sid;
    rsvc_id[i] = (int32_t)rid;
    name_id[i] = (int32_t)nid;
    key_id[i] = (int32_t)pairtab_intern(&v->pairs, sid, nid);
  }
  return count;
}
