// Native FASTQ parser for bowtie_tpu_torch's reader (io/readers.py).
//
// A copy of parse_fastq from bowtie_tpu/native/fastio.cpp, without its
// per-base code matrix, which no caller of the port reads (the reader
// derives codes from the sequence when an aligner asks for them).  The
// reference implements its read-input layer in C++ (pat.h/pat.cpp); here
// the consumer is one batched pipeline, so the native layer's job is raw
// parse throughput: turn a byte buffer into record offsets in one pass.
//
// Plain C ABI, consumed through ctypes; no global state.
#include <cstdint>

extern "C" {

// Parse a FASTQ buffer.  For each record i (up to max_reads):
//   name_off[i]/name_len[i]: read name (after '@', '\r' stripped)
//   seq_off[i]/seq_len[i]:   sequence bytes ('\r' stripped)
//   qual_off[i]:             quality bytes (length == seq_len[i])
// Returns the number of records parsed; *consumed is the number of
// buffer bytes consumed through the last complete record.  Parsing stops
// at the first record it cannot read whole; the caller then has the
// unparsed rest of the buffer past *consumed.
int64_t parse_fastq(const uint8_t* buf, int64_t len, int64_t max_reads,
                    int64_t* name_off, int32_t* name_len,
                    int64_t* seq_off, int32_t* seq_len,
                    int64_t* qual_off, int64_t* consumed)
{
    int64_t i = 0, n = 0;
    *consumed = 0;
    while (n < max_reads) {
        // skip blank lines
        while (i < len && (buf[i] == '\n' || buf[i] == '\r')) i++;
        if (i >= len || buf[i] != '@') break;
        int64_t rec_start = i;
        i++;                                   // past '@'
        int64_t ns = i;
        while (i < len && buf[i] != '\n') i++;
        if (i >= len) { i = rec_start; break; }
        int64_t ne = i; i++;
        while (ne > ns && buf[ne-1] == '\r') ne--;
        int64_t ss = i;
        while (i < len && buf[i] != '\n') i++;
        if (i >= len) { i = rec_start; break; }
        int64_t se = i; i++;
        while (se > ss && buf[se-1] == '\r') se--;
        if (i >= len || buf[i] != '+') { i = rec_start; break; }
        while (i < len && buf[i] != '\n') i++;
        if (i >= len) { i = rec_start; break; }
        i++;
        int64_t qs = i;
        int64_t want = se - ss;
        if (i + want > len) { i = rec_start; break; }
        i += want;
        // trailing newline(s) handled on next iteration
        name_off[n] = ns; name_len[n] = (int32_t)(ne - ns);
        seq_off[n]  = ss; seq_len[n]  = (int32_t)(se - ss);
        qual_off[n] = qs;
        n++;
        *consumed = i;
    }
    return n;
}

}  // extern "C"
