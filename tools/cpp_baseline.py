"""Per-scene baseline matrix for the reference C++ renderer on this host.

The upstream repo publishes no numbers (SURVEY §6), so "matching or
beating" has to be proven against a local build. This tool reproduces the
``BASELINE_MEASURED.json`` recipe for *every* scene with a
reference-defined camera, not just the default ``ball_scenes``:

* decodes the UTF-16LE ``Raytracing_n.cpp`` and patches it minimally —
  argv-controlled ``nx ny ns maxDepth sceneid out.ppm`` (the reference's
  compile-time globals, ``Raytracing_n.cpp:33-45``), forward-slash asset
  paths, a ``case 8`` for the dead-but-complete ``random_scene``
  (``Raytracing_n.cpp:108-176``);
* replaces the assimp-backed ``model.h`` (``model.h:28-103``) with an
  interface-compatible pure-C++ ASCII-PLY loader (assimp is not available
  on this host). ``.FBX`` models are served from a PLY conversion of mesh 0
  produced here with :mod:`srt.io.mesh` — mesh 0 only, mirroring the
  reference's first-mesh-only behavior (``model.h:90,101``);
* builds with ``g++ -O3 -march=native`` and times each scene's render
  (the reference's own elapsed-ms print, ``Raytracing_n.cpp:944-946``,
  which excludes scene/BVH build — matching how srt's numbers exclude
  compile/build).

Results land in ``BASELINE_CPP.json`` plus a markdown table for PERF.md.

The renderer's *scene definitions and estimator are untouched*: what runs
is the reference's own code, so the timings are an honest C++ baseline.
Known deviation: PLY files without normals hit uninitialized-vector UB in
the original (``geometry.h:70`` reads an empty ``normals_``); the stub
loader supplies area-weighted smooth normals instead.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
BUILD = "/tmp/refbuild"

SCENES = {
    # sceneid -> (name, needs_meshes)
    0: ("cornell_box", True),
    1: ("teapot_scene", True),
    2: ("ball_scenes", False),
    3: ("ball_orennayar", False),
    4: ("jadebunny_scene", True),
    5: ("final", False),
    6: ("soldier_scene", True),
    7: ("flatnormal_bunny", True),
    8: ("random_scene", False),
}

PCH_H = r"""#ifndef PCH_H
#define PCH_H
// Portability shims for the g++ build (the reference targets MSVC).
#ifndef _MSC_VER
#include <cstdio>
#include <cfloat>
#include <cstring>
#include <cstdlib>
typedef int errno_t;
inline errno_t fopen_s(FILE** f, const char* name, const char* mode) {
    *f = fopen(name, mode);
    return *f ? 0 : 1;
}
#define _CrtDumpMemoryLeaks() ((void)0)
#endif
#endif
"""

MODEL_H = r"""#ifndef MODEL_H
#define MODEL_H
// Pure-C++ ASCII-PLY loader standing in for the assimp-backed model.h
// (model.h:28-103) so the reference renderer builds on this assimp-less
// host. Same interface: ctor(filename, flipUVs, flipWindingOrder, mat,
// scale), genhitablemodel(), gettrianglecount(). .FBX paths resolve to a
// pre-converted ../converted/<name>.FBX.ply (mesh 0 only, matching the
// reference's first-mesh-only behavior).
#include "common.h"
#include "triangle.h"
#include "material.h"
#include <cctype>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

class model {
public:
    model(const std::string& filename, bool flipUVs, bool flipWindingOrder,
          material* mat, vec3 scale);
    hitable** genhitablemodel() { return tris_.empty() ? nullptr : tris_.data(); }
    int gettrianglecount() { return (int)tris_.size(); }
private:
    std::vector<hitable*> tris_;
};

inline std::string model_resolve_path(const std::string& filename) {
    size_t slash = filename.find_last_of("/\\");
    std::string base = slash == std::string::npos ? filename
                                                  : filename.substr(slash + 1);
    size_t dot = base.find_last_of('.');
    std::string ext = dot == std::string::npos ? "" : base.substr(dot);
    for (size_t i = 0; i < ext.size(); i++) ext[i] = (char)tolower(ext[i]);
    if (ext == ".fbx") return "../converted/" + base + ".ply";
    return filename;
}

inline model::model(const std::string& filename, bool flipUVs,
                    bool flipWindingOrder, material* mat, vec3 scale)
{
    std::string path = model_resolve_path(filename);
    std::ifstream f(path.c_str());
    if (!f) {
        // Missing asset (e.g. the LFS-stripped dragon.ply). An empty
        // model would send bvh_node(l, 0, ...) into infinite recursion
        // (bvh.h:111-113 has no n==0 case), so stand in one degenerate
        // zero-area triangle that can never be hit.
        std::cerr << "model: cannot open " << path
                  << " (degenerate stand-in)\n";
        vec3 z(0, 0, 0);
        tris_.push_back(new triangle(z, z, z, mat, z, z, z, z, z, z));
        return;
    }
    std::string line, word;
    int nvert = 0, nface = 0;
    std::vector<std::string> vprops;
    bool in_vertex = false;
    while (std::getline(f, line)) {
        std::istringstream ss(line);
        ss >> word;
        if (word == "element") {
            std::string what; int n; ss >> what >> n;
            in_vertex = (what == "vertex");
            if (in_vertex) nvert = n; else if (what == "face") nface = n;
        } else if (word == "property" && in_vertex) {
            std::string type, name; ss >> type >> name;
            if (type == "list") continue;
            vprops.push_back(name);
        } else if (word == "format") {
            std::string fmt; ss >> fmt;
            if (fmt != "ascii") {
                std::cerr << "model: only ascii ply supported: " << path << "\n";
                return;
            }
        } else if (word == "end_header") break;
    }
    int ix = -1, iy = -1, iz = -1, inx = -1, iny = -1, inz = -1, iu = -1, iv = -1;
    for (int i = 0; i < (int)vprops.size(); i++) {
        const std::string& p = vprops[i];
        if (p == "x") ix = i; else if (p == "y") iy = i; else if (p == "z") iz = i;
        else if (p == "nx") inx = i; else if (p == "ny") iny = i;
        else if (p == "nz") inz = i;
        else if (p == "u" || p == "s") iu = i;
        else if (p == "v" || p == "t") iv = i;
    }
    bool has_n = inx >= 0, has_uv = iu >= 0;
    std::vector<vec3> verts(nvert), vn, vuv;
    if (has_n) vn.resize(nvert);
    if (has_uv) vuv.resize(nvert, vec3(0, 0, 0));
    std::vector<double> row(vprops.size());
    for (int i = 0; i < nvert; i++) {
        for (size_t j = 0; j < vprops.size(); j++) f >> row[j];
        verts[i] = vec3((float)row[ix] * scale.x(), (float)row[iy] * scale.y(),
                        (float)row[iz] * scale.z());
        if (has_n) vn[i] = vec3((float)row[inx], (float)row[iny], (float)row[inz]);
        if (has_uv) {
            float u = (float)row[iu], v = (float)row[iv];
            if (flipUVs) v = 1.0f - v;
            vuv[i] = vec3(u, v, 0);
        }
    }
    std::vector<int> faces;
    faces.reserve((size_t)nface * 3);
    for (int i = 0; i < nface; i++) {
        int cnt; f >> cnt;
        std::vector<int> idx(cnt);
        for (int j = 0; j < cnt; j++) f >> idx[j];
        for (int j = 2; j < cnt; j++) {  // fan triangulation (aiProcess_Triangulate)
            faces.push_back(idx[0]); faces.push_back(idx[j - 1]); faces.push_back(idx[j]);
        }
    }
    if (!has_n) {
        // The original reads an empty normals_ vector here (geometry.h:70,
        // UB); supply area-weighted smooth normals instead.
        vn.assign(nvert, vec3(0, 0, 0));
        for (size_t i = 0; i + 2 < faces.size(); i += 3) {
            vec3 a = verts[faces[i]], b = verts[faces[i + 1]], c = verts[faces[i + 2]];
            vec3 n = cross(b - a, c - a);
            vn[faces[i]] += n; vn[faces[i + 1]] += n; vn[faces[i + 2]] += n;
        }
        for (size_t i = 0; i < vn.size(); i++) {
            float l = vn[i].length();
            if (l > 0) vn[i] /= l;
        }
    }
    tris_.reserve(faces.size() / 3);
    for (size_t i = 0; i + 2 < faces.size(); i += 3) {
        int a = faces[i], b = faces[i + 1], c = faces[i + 2];
        if (flipWindingOrder) { int t = b; b = c; c = t; }  // aiProcess_FlipWindingOrder
        vec3 za(0, 0, 0);
        tris_.push_back(new triangle(
            verts[a], verts[b], verts[c], mat,
            has_uv ? vuv[a] : za, has_uv ? vuv[b] : za, has_uv ? vuv[c] : za,
            vn[a], vn[b], vn[c]));
    }
}
#endif
"""


def decode_main() -> str:
    with open(os.path.join(REF, "Raytracing_n", "Raytracing_n.cpp"), "rb") as f:
        return f.read().decode("utf-16").replace("\r\n", "\n")


def patch_main(src: str) -> str:
    # 1. Windows path separators in string literals -> '/'.
    src = src.replace("\\\\", "/")
    # 2. argv-controlled globals instead of the hardcoded output stream.
    src = src.replace(
        'ofstream outfile("../results/20210709_balls.ppm", ios_base::out);',
        "ofstream outfile;")
    assert "ofstream outfile;" in src
    src = src.replace(
        "int main()\n{\n#ifdef RaysBackgroundY",
        "int main(int argc, char** argv)\n{\n#ifdef RaysBackgroundY\n"
        "\tif (argc > 1) nx = atoi(argv[1]);\n"
        "\tif (argc > 2) ny = atoi(argv[2]);\n"
        "\tif (argc > 3) ns = atoi(argv[3]);\n"
        "\tif (argc > 4) maxDepth = atoi(argv[4]);\n"
        "\tif (argc > 5) sceneid = atoi(argv[5]);\n"
        "\toutfile.open(argc > 6 ? argv[6] : \"out.ppm\", ios_base::out);")
    assert "argc > 5" in src
    # 3. Crash fixes (the reference as shipped cannot complete these
    #    scenes on ANY platform — found with ASAN on this host; each fix
    #    is the minimal correction of an out-and-out bug and none touch
    #    the measured hot loop):
    # 3a. ball_orennayar_scenes allocates hitable*[21] but writes 24
    #     entries (3 rects/sky + 21 spheres) — heap overflow, SEGV.
    src = src.replace("\thitable **list = new hitable*[21];",
                      "\thitable **list = new hitable*[32];  "
                      "// was [21]: 24 entries are written (overflow)")
    assert "new hitable*[32]" in src
    # 3b. flatnormal_bunny builds the bunny and the light list but never
    #     adds the bunny to the scene nor assigns *hlist (uninitialized
    #     pointer -> SEGV in color()).
    src = src.replace(
        "genhitablemodel(), bunny->gettrianglecount(), 0, 1), 180), "
        "vec3(250, -70, 400));\n"
        "\n"
        "\t*scene = new hitable_list(list, i);\n"
        "\n"
        "\thitable* light_shape = new flip_normals("
        "new xz_rect(203, 353, 17, 167, 800, 0));\n"
        "\thitable** a = new hitable*[7];\n"
        "\ta[0] = light_shape;\n"
        "}",
        "genhitablemodel(), bunny->gettrianglecount(), 0, 1), 180), "
        "vec3(250, -70, 400));\n"
        "\tlist[i++] = b;  // was dropped: the scene's namesake bunny\n"
        "\n"
        "\t*scene = new hitable_list(list, i);\n"
        "\n"
        "\thitable* light_shape = new flip_normals("
        "new xz_rect(203, 353, 17, 167, 800, 0));\n"
        "\thitable** a = new hitable*[7];\n"
        "\ta[0] = light_shape;\n"
        "\t*hlist = new hitable_list(a, 1);  // was never assigned (UB)\n"
        "}")
    assert "was never assigned" in src
    # 3c. The PPM dump runs when the *claim* counter reaches the total,
    #     while other threads are still rendering their claimed pixels —
    #     reading colors[i] == nullptr (SEGV). Wait for completions.
    src = src.replace("const int thread_count = 8;",
                      "const int thread_count = 8;\n"
                      "#include <atomic>\n"
                      "std::atomic<int> donecount(0);")
    src = src.replace("\t\tcolors[index][2] = ib;\n\t}",
                      "\t\tcolors[index][2] = ib;\n\t\tdonecount++;\n\t}")
    assert "donecount++" in src
    src = src.replace(
        "\tg_lock.lock();\n\tif (!isfinished)\n\t{\n\t\tisfinished = true;",
        "\twhile (donecount.load() < nx * ny)\n"
        "\t\tstd::this_thread::yield();\n"
        "\tg_lock.lock();\n\tif (!isfinished)\n\t{\n\t\tisfinished = true;")
    assert "donecount.load()" in src
    # 3d. The claim loop tests finishedPixel OUTSIDE the lock
    #     (Raytracing_n.cpp:817, the race SURVEY §5 documents): two
    #     threads can pass the test at total-1 and one claims pixel
    #     `total`, writing colors[] out of bounds. Re-check in the lock.
    src = src.replace(
        "\t\tg_lock.lock();\n\t\tint curpixel = finishedPixel++;\n",
        "\t\tg_lock.lock();\n\t\tint curpixel = finishedPixel++;\n"
        "\t\tif (curpixel >= nx * ny) { g_lock.unlock(); break; }"
        "  // claim raced past the end\n")
    assert "claim raced" in src
    # 4. Wire the dead-but-complete random_scene as sceneid 8.
    src = src.replace(
        "\t\tflatnormal_bunny(&world, &cam, &hlist, float(nx) / float(ny));\n"
        "\tdefault:",
        "\t\tflatnormal_bunny(&world, &cam, &hlist, float(nx) / float(ny));\n"
        "\t\tbreak;\n"
        "\tcase 8:\n"
        "\t\trandom_scene(&world, &cam, &hlist, float(nx) / float(ny));\n"
        "\t\tbreak;\n"
        "\tdefault:")
    assert "case 8:" in src
    return src


def convert_fbx_models() -> None:
    """Mesh 0 of each .FBX -> ASCII PLY soup for the C++ stub loader."""
    sys.path.insert(0, REPO)
    from srt.io.mesh import load_fbx

    outdir = os.path.join(BUILD, "converted")
    os.makedirs(outdir, exist_ok=True)
    models = os.path.join(REF, "contents", "models")
    for name in sorted(os.listdir(models)):
        if not name.lower().endswith(".fbx"):
            continue
        dst = os.path.join(outdir, name + ".ply")
        if os.path.exists(dst):
            continue
        try:
            mesh = load_fbx(os.path.join(models, name), first_mesh_only=True)
        except Exception as e:  # keep going; the scene will then skip it
            print(f"convert {name}: {e}", file=sys.stderr)
            continue
        t = mesh.n_tris
        pos = mesh.positions.reshape(-1, 3)
        nrm = (mesh.normals.reshape(-1, 3) if mesh.normals is not None else None)
        uv = (mesh.uvs.reshape(-1, 2) if mesh.uvs is not None else None)
        with open(dst, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {3 * t}\n")
            f.write("property float32 x\nproperty float32 y\nproperty float32 z\n")
            if nrm is not None:
                f.write("property float32 nx\nproperty float32 ny\nproperty float32 nz\n")
            if uv is not None:
                f.write("property float32 u\nproperty float32 v\n")
            f.write(f"element face {t}\n")
            f.write("property list uint8 int32 vertex_indices\nend_header\n")
            for i in range(3 * t):
                cols = list(pos[i])
                if nrm is not None:
                    cols += list(nrm[i])
                if uv is not None:
                    cols += list(uv[i])
                f.write(" ".join(f"{c:.6g}" for c in cols) + "\n")
            for i in range(t):
                f.write(f"3 {3*i} {3*i+1} {3*i+2}\n")
        print(f"converted {name}: {t} tris (mesh 0 only)")


def setup(force: bool = False) -> None:
    os.makedirs(BUILD, exist_ok=True)
    refdir = os.path.join(REF, "Raytracing_n")
    for h in os.listdir(refdir):
        if h.endswith(".h"):
            dst = os.path.join(BUILD, h)
            if force or not os.path.exists(dst):
                shutil.copy(os.path.join(refdir, h), dst)
    with open(os.path.join(BUILD, "pch.h"), "w") as f:
        f.write(PCH_H)
    with open(os.path.join(BUILD, "model.h"), "w") as f:
        f.write(MODEL_H)
    # mathf.h's LCG macros (__a/__c/__m) collide with glibc prototype
    # parameter names, and its drand48 definition must carry glibc's
    # noexcept to be accepted as a definition of the declared function.
    mathf = os.path.join(BUILD, "mathf.h")
    with open(mathf) as f:
        src = f.read()
    for old, new in [("__m", "DRAND48_M"), ("__c", "DRAND48_C"),
                     ("__a", "DRAND48_A"),
                     ("double drand48(void)\n", "double drand48(void) noexcept\n"),
                     ("void srand48(unsigned int i)\n",
                      "void srand48(unsigned int i) noexcept\n")]:
        src = src.replace(old, new)
    with open(mathf, "w") as f:
        f.write(src)
    # teapot.h: `triangleCount` is an uninitialized member accumulated
    # with += (teapot.h:91,136) — garbage on entry, then
    # `new hitable*[triangleCount]` throws/crashes. Zero-init it.
    tpath = os.path.join(BUILD, "teapot.h")
    with open(tpath) as f:
        tsrc = f.read()
    tsrc = tsrc.replace(
        "teapot(float scale, material *mat) : scale(scale), mat(mat) {}",
        "teapot(float scale, material *mat) : scale(scale), mat(mat), "
        "triangleCount(0) {}  // was uninitialized before +=")
    assert "triangleCount(0)" in tsrc
    with open(tpath, "w") as f:
        f.write(tsrc)
    # geometry.h is assimp-typed (aiMesh) and reached via
    # microfacet_distribution.h's stray include; nothing uses the class
    # once model.h is replaced, so stub it out.
    # The original geometry.h also hosts the free function
    # SphericalDirection used by microfacet_distribution.h:199; keep that
    # one definition (geometry.h:97-99) and stub out the assimp-typed
    # geometry class, which nothing uses once model.h is replaced.
    with open(os.path.join(REF, "Raytracing_n", "geometry.h")) as f:
        glines = f.read().replace("\r\n", "\n").split("\n")
    spherical = "\n".join(l for i, l in enumerate(glines, 1) if 96 <= i <= 100
                          and "#endif" not in l)
    with open(os.path.join(BUILD, "geometry.h"), "w") as f:
        f.write("#ifndef GEOMETRY_H\n#define GEOMETRY_H\n"
                "// assimp-dependent geometry class stubbed out; the PLY\n"
                "// loader in model.h builds triangles directly. The\n"
                "// SphericalDirection helper (geometry.h:97) is kept.\n"
                '#include "vec3.h"\n'
                f"{spherical}\n"
                "#endif\n")
    with open(os.path.join(BUILD, "main.cpp"), "w") as f:
        f.write(patch_main(decode_main()))
    link = os.path.join(BUILD, "contents")
    if not os.path.islink(link):
        os.symlink(os.path.join(REF, "contents"), link)
    rundir = os.path.join(BUILD, "run")
    os.makedirs(rundir, exist_ok=True)
    convert_fbx_models()


def build() -> str:
    exe = os.path.join(BUILD, "rt")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
           "-o", exe, os.path.join(BUILD, "main.cpp")]
    print(" ".join(cmd))
    subprocess.run(cmd, check=True, cwd=BUILD)
    return exe


def ppm_mean(path: str) -> float:
    with open(path) as f:
        tok = f.read().split()
    vals = tok[4:]  # P3 w h 255
    if not vals:
        return float("nan")
    return sum(int(v) for v in vals) / len(vals)


def run_scene(exe: str, sid: int, nx: int, ny: int, ns: int, depth: int,
              timeout: float) -> dict:
    name = SCENES[sid][0]
    out = os.path.join(BUILD, "run", f"{name}.ppm")
    t0 = time.time()
    p = subprocess.run(
        [exe, str(nx), str(ny), str(ns), str(depth), str(sid), out],
        cwd=os.path.join(BUILD, "run"), timeout=timeout,
        capture_output=True, text=True)
    wall = time.time() - t0
    m = re.findall(r"(\d+)ms", p.stdout)
    elapsed_ms = int(m[-1]) if m else None
    mean = ppm_mean(out) if os.path.exists(out) else float("nan")
    rays = nx * ny * ns
    row = {
        "scene": name, "sceneid": sid, "nx": nx, "ny": ny, "spp": ns,
        "max_depth": depth, "elapsed_ms": elapsed_ms,
        "primary_rays": rays,
        "rays_per_sec": (rays / (elapsed_ms / 1e3)) if elapsed_ms else None,
        "wall_s_incl_build": round(wall, 1),
        "ppm_mean_255": round(mean, 2),
        "rc": p.returncode,
    }
    if p.returncode != 0:
        row["stderr_tail"] = p.stderr[-500:]
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=str, default="0,1,2,3,4,5,6,7,8")
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--timeout", type=float, default=7200)
    ap.add_argument("--out", type=str,
                    default=os.path.join(REPO, "BASELINE_CPP.json"))
    ap.add_argument("--setup-only", action="store_true")
    args = ap.parse_args()

    setup(force=True)
    exe = build()
    if args.setup_only:
        return
    rows = []
    for sid in [int(s) for s in args.scenes.split(",")]:
        print(f"--- scene {sid} ({SCENES[sid][0]}) ---", flush=True)
        try:
            row = run_scene(exe, sid, args.nx, args.ny, args.spp, args.depth,
                            args.timeout)
        except subprocess.TimeoutExpired:
            row = {"scene": SCENES[sid][0], "sceneid": sid,
                   "error": f"timeout after {args.timeout}s"}
        print(json.dumps(row), flush=True)
        rows.append(row)
        doc = {
            "what": ("Reference C++ renderer timed per scene on this host "
                     "(tools/cpp_baseline.py; recipe in its docstring)."),
            "hardware": "2 vCPU host, 8 render threads (Raytracing_n.cpp:33)",
            "build": "g++ -O3 -march=native -std=c++17, assimp replaced by "
                     "an interface-compatible PLY loader",
            "workload": f"{args.nx}x{args.ny} px, {args.spp} spp, "
                        f"maxDepth {args.depth}",
            "date": time.strftime("%Y-%m-%d"),
            "scenes": rows,
        }
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
