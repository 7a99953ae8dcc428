// PTB-style caption tokenizer — C++ twin of metrics/tokenizer.py (own
// copy of the reference package's native/tokenizer.cpp).
//
// The reference's tokenizer is NATIVE code (the Stanford CoreNLP
// PTBTokenizer jar, invoked as a subprocess by coco-caption; SURVEY.md §2
// native table).  metrics/tokenizer.py reimplements its observable
// contract in pure Python; this file is the same contract in C++ for the
// bulk corpus paths (trainer startup tokenizes every training caption,
// language_eval every prediction).  Parity with the Python implementation
// is pinned token-for-token by tests/test_torch_native.py (against the
// reference package's twin) and by metrics/tokenizer.py's start-up probe;
// the Python module remains the oracle and the fallback, and non-ASCII
// captions are always routed to Python (C++ would need ICU for unicode
// case folding).
//
// Contract (mirrors metrics/tokenizer.py EXACTLY, quirks included):
//   1. isolate "..."/"--" and the punctuation set , ; : @ # $ % & ? ! "
//      ( ) { } [ ] < > = + / \ * ^ ~ |
//   2. split contraction suffixes ('ll 're 've n't 's 'm 'd) off a
//      preceding letter when followed by a non-word char, left to right,
//      non-overlapping
//   3. per whitespace token: special splits (cannot -> can not, ...);
//      else drop ONE sentence-terminal period unless the token is
//      abbreviation-shaped (([a-z].)+); strip surrounding apostrophes
//      unless the token is itself a kept contraction token; map brackets
//      to -LRB-/-RRB-/-LCB-/-RCB-; drop coco-caption's punctuation set;
//      lowercase.
//
// extern "C" surface (ctypes, no pybind11 per environment constraints):
//   ptb_tokenize(in, out, cap) -> bytes written to out (space-joined
//   tokens), or -1 if out is too small.  ASCII-only input expected.

#include <cctype>
#include <cstring>
#include <string>
#include <vector>

namespace {

bool is_isolate_char(char c) {
    switch (c) {
        case ',': case ';': case ':': case '@': case '#': case '$':
        case '%': case '&': case '?': case '!': case '"': case '(':
        case ')': case '{': case '}': case '[': case ']': case '<':
        case '>': case '=': case '+': case '/': case '\\': case '*':
        case '^': case '~': case '|':
            return true;
        default:
            return false;
    }
}

bool is_word_char(char c) {
    return std::isalnum(static_cast<unsigned char>(c)) || c == '_';
}

char lower(char c) {
    return static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
}

// Contraction suffixes, longest first ("n't" before "'d" etc. is not
// required for correctness — matches start at a fixed position — but keep
// the regex's alternation order for identical left-to-right semantics.
const char* kSuffixes[] = {"'ll", "'re", "'ve", "n't", "'s", "'m", "'d"};

bool match_ci(const std::string& s, size_t pos, const char* pat) {
    size_t n = std::strlen(pat);
    if (pos + n > s.size()) return false;
    for (size_t k = 0; k < n; ++k) {
        if (lower(s[pos + k]) != pat[k]) return false;
    }
    return true;
}

struct SpecialSplit {
    const char* word;
    const char* a;
    const char* b;
};
const SpecialSplit kSpecial[] = {
    {"cannot", "can", "not"}, {"gonna", "gon", "na"},
    {"gotta", "got", "ta"},   {"wanna", "wan", "na"},
    {"lemme", "lem", "me"},   {"gimme", "gim", "me"},
    {"d'ye", "d'", "ye"},     {"'tis", "'t", "is"},
    {"'twas", "'t", "was"},
};

const char* kContractionTokens[] = {"'s", "'re", "'ve", "'ll",
                                    "'m", "'d", "n't", "'t"};

// Original case, matching the Python set exactly: a LITERAL input token
// "-lrb-" is kept by the oracle (the set holds only "-LRB-", and the
// lowercase membership test compares against the uppercase entries), while
// the bracket-mapped "-LRB-" matches case-sensitively and is dropped.
const char* kPunctuations[] = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
};

bool is_abbrev(const std::string& t) {  // ^([a-z]\.)+$ case-insensitive
    if (t.empty() || t.size() % 2 != 0) return false;
    for (size_t i = 0; i < t.size(); i += 2) {
        if (!std::isalpha(static_cast<unsigned char>(t[i])) ||
            t[i + 1] != '.') {
            return false;
        }
    }
    return true;
}

std::string to_lower(const std::string& t) {
    std::string out(t);
    for (char& c : out) c = lower(c);
    return out;
}

void emit(std::vector<std::string>& out, const std::string& raw) {
    std::string tok = raw;
    std::string low = to_lower(tok);
    for (const auto& sp : kSpecial) {
        if (low == sp.word) {
            out.push_back(sp.a);
            out.push_back(sp.b);
            return;
        }
    }
    // Sentence-terminal period: split off ONE unless abbreviation-shaped
    // or the token is dots-only (strip('.') empty in the Python source).
    if (!tok.empty() && tok.back() == '.') {
        bool all_dots = tok.find_first_not_of('.') == std::string::npos;
        if (!all_dots && !is_abbrev(tok)) tok.pop_back();
    }
    // Surrounding apostrophes are quote chars; contraction tokens exempt.
    low = to_lower(tok);
    bool keep_apostrophes = false;
    for (const char* ct : kContractionTokens) {
        if (low == ct) { keep_apostrophes = true; break; }
    }
    if (!keep_apostrophes) {
        size_t b = tok.find_first_not_of('\'');
        if (b == std::string::npos) {
            tok.clear();
        } else {
            size_t e = tok.find_last_not_of('\'');
            tok = tok.substr(b, e - b + 1);
        }
    }
    if (tok.empty()) return;
    if (tok == "(" || tok == "[") tok = "-LRB-";
    else if (tok == ")" || tok == "]") tok = "-RRB-";
    else if (tok == "{") tok = "-LCB-";
    else if (tok == "}") tok = "-RCB-";
    low = to_lower(tok);
    // Mirror Python: tok in PUNCTUATIONS or low in PUNCTUATIONS or low == '"'
    for (const char* p : kPunctuations) {
        if (tok == p || low == p) return;
    }
    if (low == "\"") return;
    out.push_back(low);
}

// Python str.split() whitespace within ASCII: \t\n\v\f\r, \x1c-\x1f, space
// (C isspace misses the information-separator range \x1c-\x1f).
bool is_py_space(char c) {
    unsigned char u = static_cast<unsigned char>(c);
    return (u >= 0x09 && u <= 0x0d) || (u >= 0x1c && u <= 0x1f) || u == ' ';
}

std::vector<std::string> tokenize(const std::string& caption) {
    // Pass 1: newline -> space; isolate .../--/punctuation chars.
    std::string s;
    s.reserve(caption.size() * 2);
    for (size_t i = 0; i < caption.size();) {
        char c = caption[i];
        if (c == '\n') {
            s += ' ';
            ++i;
        } else if (c == '.' && i + 2 < caption.size() &&
                   caption[i + 1] == '.' && caption[i + 2] == '.') {
            s += " ... ";
            i += 3;
        } else if (c == '-' && i + 1 < caption.size() &&
                   caption[i + 1] == '-') {
            s += " -- ";
            i += 2;
        } else if (is_isolate_char(c)) {
            s += ' ';
            s += c;
            s += ' ';
            ++i;
        } else {
            s += c;
            ++i;
        }
    }
    // Pass 2: contraction suffix splitting, left to right, non-overlapping.
    // re.sub resumes scanning AFTER each match, and the match includes the
    // preceding letter (group 1) — so a suffix whose letter was consumed by
    // the previous match must NOT split ("can't've" -> "ca n't've", the
    // 've stays attached).  last_end tracks the consumed frontier.
    std::string t;
    t.reserve(s.size() + 16);
    size_t last_end = 0;
    for (size_t i = 0; i < s.size();) {
        bool matched = false;
        if (i > 0 && i - 1 >= last_end &&
            std::isalpha(static_cast<unsigned char>(s[i - 1]))) {
            for (const char* suf : kSuffixes) {
                if (match_ci(s, i, suf)) {
                    size_t end = i + std::strlen(suf);
                    if (end >= s.size() || !is_word_char(s[end])) {
                        t += ' ';
                        t.append(s, i, std::strlen(suf));
                        i = end;
                        last_end = end;
                        matched = true;
                        break;
                    }
                }
            }
        }
        if (!matched) {
            t += s[i];
            ++i;
        }
    }
    // Pass 3: whitespace split + per-token normalization.
    std::vector<std::string> out;
    size_t i = 0;
    while (i < t.size()) {
        while (i < t.size() && is_py_space(t[i])) ++i;
        size_t start = i;
        while (i < t.size() && !is_py_space(t[i])) ++i;
        if (i > start) emit(out, t.substr(start, i - start));
    }
    return out;
}

}  // namespace

extern "C" {

// Tokenize one ASCII caption; write space-joined tokens to out.
// Returns bytes written (excluding NUL), or -1 if out_cap is too small.
int ptb_tokenize(const char* in, char* out, int out_cap) {
    std::vector<std::string> toks = tokenize(std::string(in));
    size_t need = 0;
    for (const auto& t : toks) need += t.size() + 1;
    if (need + 1 > static_cast<size_t>(out_cap)) return -1;
    char* p = out;
    for (size_t k = 0; k < toks.size(); ++k) {
        if (k) *p++ = ' ';
        std::memcpy(p, toks[k].data(), toks[k].size());
        p += toks[k].size();
    }
    *p = '\0';
    return static_cast<int>(p - out);
}

// Batch form: caption i is buf[offs[i]..offs[i+1]).  Outputs are written
// back-to-back into out with out_offs[i]..out_offs[i+1] delimiting
// caption i's space-joined tokens (out_offs has n+1 entries).  Returns
// total bytes written, or -1 if out_cap is too small.  One call replaces
// n ctypes round trips on the corpus-tokenization path.
int ptb_tokenize_batch(const char* buf, const int* offs, int n,
                       char* out, int out_cap, int* out_offs) {
    size_t pos = 0;
    out_offs[0] = 0;
    for (int i = 0; i < n; ++i) {
        std::string caption(buf + offs[i], buf + offs[i + 1]);
        std::vector<std::string> toks = tokenize(caption);
        size_t need = 0;
        for (const auto& t : toks) need += t.size() + 1;
        if (pos + need > static_cast<size_t>(out_cap)) return -1;
        for (size_t k = 0; k < toks.size(); ++k) {
            if (k) out[pos++] = ' ';
            std::memcpy(out + pos, toks[k].data(), toks[k].size());
            pos += toks[k].size();
        }
        out_offs[i + 1] = static_cast<int>(pos);
    }
    return static_cast<int>(pos);
}

}  // extern "C"
