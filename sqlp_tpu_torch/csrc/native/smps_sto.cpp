// Native SMPS .sto (stochastic file) parser.
//
// Copy of csrc/smps_sto.cpp for sqlp_tpu_torch. Mirrors
// sqlp_tpu_torch/models/smps_sto.py exactly (itself the behavioral port
// of the reference's src/smps/smps_sto.jl:41-111): sections STOCH/INDEP/
// ENDATA, '*' comments, indented lines are data rows, only univariate
// DISCRETE / NORMAL / UNIFORM marginals in INDEP. Position order is first
// appearance. DISCRETE rows for an existing position append outcomes.
//
// Exposed through the same C ABI protocol as the cor parser: parse ->
// query sizes -> fill caller-allocated numpy buffers -> free. Per-position
// parameters flatten into two parallel double arrays sliced by offsets:
// discrete positions own (#outcomes) slots of (value, probability); normal
// and uniform positions own 1 slot of (mean, variance) / (left, right).

#include <cctype>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum Kind { kDiscrete = 0, kNormal = 1, kUniform = 2 };

struct StoPosition {
    std::string col, row;
    int kind;
    std::vector<double> a;  // values / mean / left
    std::vector<double> b;  // probabilities / variance / right
};

struct StoHandle {
    std::string problem_name;
    std::vector<StoPosition> positions;  // in order of first appearance
    std::unordered_map<std::string, int> index;  // "col\trow" -> position
};

bool tokenize(const std::string& line, std::vector<std::string>* out) {
    out->clear();
    std::istringstream ss(line);
    std::string tok;
    while (ss >> tok) out->push_back(tok);
    return !out->empty();
}

}  // namespace

extern "C" {

void* smps_sto_parse(const char* path, char* err, int errcap) {
    auto fail = [&](const std::string& msg) -> void* {
        if (err && errcap > 0) std::snprintf(err, errcap, "%s", msg.c_str());
        return nullptr;
    };

    std::ifstream in(path);
    if (!in) return fail(std::string("cannot open ") + path);

    auto h = new StoHandle();
    std::string section;
    std::vector<std::string> keywords;
    std::string line;
    std::vector<std::string> t;

    while (std::getline(in, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (line.empty() || line[0] == '*') continue;
        if (!tokenize(line, &t)) continue;

        if (line[0] != ' ' && line[0] != '\t') {  // header line
            section = t[0];
            if (section != "STOCH" && section != "INDEP" &&
                section != "ENDATA") {
                delete h;
                return fail("Unsupported sto section " + section);
            }
            keywords.assign(t.begin() + 1, t.end());
            if (section == "STOCH" && !keywords.empty()) {
                h->problem_name = keywords[0];
            }
            continue;
        }
        if (section != "INDEP") continue;
        if (t.size() < 4) {
            delete h;
            return fail("short INDEP data line: " + line);
        }
        if (keywords.size() > 1) {
            delete h;
            return fail("Trailing/unsupported section keywords after " +
                        keywords[0]);
        }
        const std::string& kindword = keywords.empty() ? "" : keywords[0];
        double va = std::strtod(t[2].c_str(), nullptr);
        double vb = std::strtod(t[3].c_str(), nullptr);
        std::string key = t[0] + "\t" + t[1];

        if (kindword == "DISCRETE") {
            auto it = h->index.find(key);
            if (it == h->index.end()) {
                h->index[key] = (int)h->positions.size();
                h->positions.push_back({t[0], t[1], kDiscrete, {}, {}});
                it = h->index.find(key);
            }
            StoPosition& p = h->positions[it->second];
            if (p.kind != kDiscrete) {  // Python: isinstance assert fails
                delete h;
                return fail("DISCRETE row for non-discrete position " + key);
            }
            p.a.push_back(va);
            p.b.push_back(vb);
        } else if (kindword == "NORMAL" || kindword == "UNIFORM") {
            int kind = kindword == "NORMAL" ? kNormal : kUniform;
            auto it = h->index.find(key);
            if (it == h->index.end()) {
                h->index[key] = (int)h->positions.size();
                h->positions.push_back({t[0], t[1], kind, {va}, {vb}});
            } else {  // later duplicate overwrites (matches Python dict set)
                h->positions[it->second] = {t[0], t[1], kind, {va}, {vb}};
            }
        } else {
            delete h;
            return fail("Unknown or unsupported section keywords " +
                        kindword);
        }
    }
    return h;
}

int sto_n_positions(void* vh) {
    return (int)static_cast<StoHandle*>(vh)->positions.size();
}

long sto_name_size(void* vh) {
    return (long)static_cast<StoHandle*>(vh)->problem_name.size() + 1;
}

void sto_problem_name(void* vh, char* out) {
    auto* h = static_cast<StoHandle*>(vh);
    std::memcpy(out, h->problem_name.c_str(), h->problem_name.size() + 1);
}

// newline-joined "col\trow" per position, NUL-terminated
long sto_positions_size(void* vh) {
    auto* h = static_cast<StoHandle*>(vh);
    long n = 1;
    for (const auto& p : h->positions) n += p.col.size() + p.row.size() + 2;
    return n;
}

void sto_positions(void* vh, char* out) {
    auto* h = static_cast<StoHandle*>(vh);
    std::string s;
    for (const auto& p : h->positions) s += p.col + "\t" + p.row + "\n";
    std::memcpy(out, s.c_str(), s.size() + 1);
}

void sto_kinds(void* vh, int* out) {
    auto* h = static_cast<StoHandle*>(vh);
    for (size_t i = 0; i < h->positions.size(); ++i)
        out[i] = h->positions[i].kind;
}

// offsets[n_positions + 1]: slice bounds into the flat (a, b) arrays
void sto_offsets(void* vh, long* out) {
    auto* h = static_cast<StoHandle*>(vh);
    long off = 0;
    for (size_t i = 0; i < h->positions.size(); ++i) {
        out[i] = off;
        off += (long)h->positions[i].a.size();
    }
    out[h->positions.size()] = off;
}

long sto_total_outcomes(void* vh) {
    auto* h = static_cast<StoHandle*>(vh);
    long n = 0;
    for (const auto& p : h->positions) n += (long)p.a.size();
    return n;
}

void sto_params(void* vh, double* a, double* b) {
    auto* h = static_cast<StoHandle*>(vh);
    long off = 0;
    for (const auto& p : h->positions) {
        std::memcpy(a + off, p.a.data(), p.a.size() * sizeof(double));
        std::memcpy(b + off, p.b.data(), p.b.size() * sizeof(double));
        off += (long)p.a.size();
    }
}

void sto_free(void* vh) { delete static_cast<StoHandle*>(vh); }

}  // extern "C"
