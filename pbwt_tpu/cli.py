"""pbwt command-line driver: argv is a left-to-right pipeline of commands
operating on one current PBWT, exactly as pbwtMain.c:276-494."""

from __future__ import annotations

import sys


from . import utils
from .core import registry
from .core.pbwt import PBWT
from .io import pbwtfile, textformats, vcf
from .utils import time_update
from .version import MAJOR_VERSION, MINOR_VERSION

HELP = """Program: pbwt
Version: {maj}.{min} (pbwt-tpu)
Usage: pbwt [ -<command> [options]* ]+
Commands:
  -log <file>               log file; '-' for stderr
  -profile <dir>            write a jax.profiler device trace of the rest of
                            the pipeline to <dir>; adds per-command wall time
  -check                    do various checks
  -stats                    print stats depending on commands; writes to stdout
  -read <file>              read pbwt file; '-' for stdin
  -readSites <file>         read sites file; '-' for stdin
  -readSamples <file>       read samples file; '-' for stdin
  -readMissing <file>       read missing file; '-' for stdin
  -readDosage <file>        read dosage file; '-' for stdin
  -readReverse <file>       read reverse file; '-' for stdin
  -readAll <rootname>       read .pbwt and if present .sites, .samples, .missing
  -readVcfGT <file>         read GTs from vcf or bcf file; '-' for stdin
  -readVcfPL <file>         read PLs from vcf or bcf file (stub, as reference)
  -readMacs <file>          read MaCS output file; '-' for stdin
  -readVcfq <file>          read VCFQ file; '-' for stdin
  -readGen <file> <chrom>   read impute2 gen file - must set chrom
  -readHap <file> <chrom>   read impute2 hap file - must set chrom
  -readHapLegend <hap_file> <legend_file> <chrom>
  -readPhaseChr <file> <chr> read Li and Stephens phase file
  -readPhase <file>         read Li and Stephens phase file
  -checkpoint <n>           checkpoint every n sites while reading
  -merge <file> ...         merge two or more pbwt files
  -write <file>             write pbwt file; '-' for stdout
  -writeSites <file>        write sites file; '-' for stdout
  -writeSamples <file>      write samples file; '-' for stdout
  -writeMissing <file>      write missing file; '-' for stdout
  -writeDosage <file>       write dosage file; '-' for stdout
  -writeReverse <file>      write reverse file; '-' for stdout
  -writeAll <rootname>      write .pbwt and present sidecars
  -writeImputeRef <rootname> write .imputeHaps and .imputeLegend
  -writeImputeHapsG <file>  write haplotype file for IMPUTE -known_haps_g
  -writePhase <file>        write ChromoPainter/FineSTRUCTURE phase file
  -writeTransposedHaplotypes <file> one hap per row; '-' for stdout
  -haps <file>              write haplotype file; '-' for stdout
  -writeGen <file>          write impute2 gen file; '-' for stdout
  -writeVcf|-writeVcfGz|-writeBcf|-writeBcfGz <file>  write VCF/BCF
  -referenceFasta <file>    reference fasta for VCF/BCF writing
  -subsites <fmin> <frac>   subsample <frac> sites with AF > <fmin>
  -subsample <start> <n>    subsample <n> samples from index <start>
  -subrange <start> <end>   cut down to sites in [start,end)
  -corruptSites <p> <q>     randomise fraction q of positions at fraction p of sites
  -corruptSamples <p> <q>   randomise fraction q of positions for fraction p of samples
  -copySamples <M> <len>    M new mosaic samples with mean switch length len
  -selectSites <file>       select sites as in sites file
  -removeSites <file>       remove sites as in sites file
  -selectSamples <file>     select samples as in samples file
  -longWithin <L>           find matches within set longer than L
  -maxWithin                find maximal matches within set
  -matchNaive <file>        maximal match seqs in pbwt file to reference
  -matchIndexed <file>      maximal match seqs in pbwt file to reference
  -matchDynamic <file>      maximal match seqs in pbwt file to reference
  -imputeExplore <n>        n'th impute test
  -phase <n>                phase with n sparse pbwts
  -referencePhase <root>    phase current pbwt against reference
  -referenceImpute <root> [nSparse=1] [fSparse=1]  impute into reference
  -genotypeCompare <root>   compare genotypes with reference
  -imputeMissing            impute data marked as missing
  -fitAlphaBeta <model>     fit probabilistic model 1..3
  -llCopyModel <theta> <rho> log likelihood of Li-Stephens model
  -paint <fileNameRoot> [n=100] [p=2] [l=0] painting co-ancestry matrix
  -paintSparse <fileNameRoot> [n=100] [p=2] [t=0] sparse painting
  -pretty <file> <k>        pretty plot at site k
  -sfs                      print site frequency spectrum; writes sites.freq
  -play                     compare dosage-derived info to stored imputeInfo
  -refFreq <file>           read site frequency info into refFreq
  -siteInfo <file> <kmin> <kmax> export PBWT info at sites by allele count
  -buildReverse             build reverse pbwt
  -readGeneticMap <file>    read Oxford format genetic map file
  -4hapsStats               mu:rho 4 hap test stats
"""


def _open(name: str, mode: str):
    if name == "-":
        if "r" in mode:
            return sys.stdin.buffer if "b" in mode else sys.stdin
        return sys.stdout.buffer if "b" in mode else sys.stdout
    return open(name, mode)


def _close(fp, name: str):
    if name != "-":
        fp.close()
    else:
        fp.flush()


def main(argv: list[str] | None = None) -> int:
    """die()-style wrapper: clean one-line fatal errors like the reference."""
    try:
        return _main(argv)
    except BrokenPipeError:
        return 0
    except SystemExit:
        raise
    except FileNotFoundError as e:
        sys.stderr.write(f"pbwt: failed to open file {e.filename}\n")
        return 1
    except (ValueError, AssertionError) as e:
        sys.stderr.write(f"pbwt: {e}\n")
        return 1
    except AttributeError as e:
        if "'NoneType'" in str(e):
            sys.stderr.write("pbwt: command requires a current PBWT - read one first\n")
            return 1
        raise


def _main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    registry.init()
    registry.command_line = " ".join(argv)
    utils.set_log_file(sys.stderr)

    p: PBWT | None = None
    reference_fasta: str | None = None
    profiling = False
    t_cmd = 0.0

    if not argv:
        sys.stderr.write(HELP.format(maj=MAJOR_VERSION, min=MINOR_VERSION))
        return 0

    time_update()
    while argv:
        cmd = argv[0]
        if not cmd.startswith("-"):
            raise SystemExit(f"not well formed command {cmd}\n"
                             "Type pbwt without arguments for help")

        def need(n):
            if len(argv) <= n:
                raise SystemExit(f"option {cmd} requires {n} argument(s)")

        if cmd == "-check":
            registry.is_check = True
            argv = argv[1:]
        elif cmd == "-stats":
            registry.is_stats = True
            argv = argv[1:]
        elif cmd == "-merge":
            from .algos import merge as mergemod
            files = []
            for a in argv[1:]:
                if a.startswith("-"):
                    break
                files.append(a)
            if len(files) > 1:
                p = mergemod.merge(files)
            argv = argv[1 + len(files):]
        elif cmd == "-log":
            need(1)
            utils.set_log_file(sys.stderr if argv[1] == "-" else open(argv[1], "w"))
            argv = argv[2:]
        elif cmd == "-profile":
            # device-side tracing: the device engine's analogue of the
            # reference's rusage-only timeUpdate (utils.c:173-198, SURVEY
            # section 5) — per-command wall time plus a jax.profiler trace
            # viewable in TensorBoard/XProf
            need(1)
            import jax
            jax.profiler.start_trace(argv[1])
            profiling = True
            t_cmd = __import__("time").perf_counter()
            argv = argv[2:]
        elif cmd == "-haps":
            need(1)
            fp = _open(argv[1], "w")
            textformats.write_haplotypes(fp, p)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-read":
            need(1)
            fp = _open(argv[1], "rb")
            p = pbwtfile.read_pbwt(fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readSites":
            need(1)
            fp = _open(argv[1], "r")
            pbwtfile.read_sites(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readSamples":
            need(1)
            fp = _open(argv[1], "r")
            pbwtfile.read_samples(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readMissing":
            need(1)
            fp = _open(argv[1], "rb")
            pbwtfile.read_missing(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readDosage":
            need(1)
            fp = _open(argv[1], "rb")
            pbwtfile.read_dosage(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readReverse":
            need(1)
            fp = _open(argv[1], "rb")
            pbwtfile.read_reverse(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readAll":
            need(1)
            p = pbwtfile.read_all(argv[1])
            argv = argv[2:]
        elif cmd == "-readVcfGT":
            need(1)
            p = vcf.read_vcf_gt(argv[1])
            argv = argv[2:]
        elif cmd == "-readVcfPL":
            need(1)
            p = vcf.read_vcf_pl(argv[1])
            argv = argv[2:]
        elif cmd == "-readMacs":
            need(1)
            fp = _open(argv[1], "rb")
            p = textformats.read_macs(fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readVcfq":
            need(1)
            fp = _open(argv[1], "r")
            p = textformats.read_vcfq(fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readGen":
            need(2)
            fp = _open(argv[1], "r")
            p = textformats.read_gen(fp, argv[2])
            _close(fp, argv[1])
            argv = argv[3:]
        elif cmd == "-readHap":
            need(2)
            fp = _open(argv[1], "r")
            p = textformats.read_hap(fp, argv[2])
            _close(fp, argv[1])
            argv = argv[3:]
        elif cmd == "-readHapLegend":
            need(3)
            fp = _open(argv[1], "r")
            lp = _open(argv[2], "r")
            p = textformats.read_hap(fp, argv[3], legend_fp=lp)
            _close(fp, argv[1])
            _close(lp, argv[2])
            argv = argv[4:]
        elif cmd == "-readPhase":
            need(1)
            fp = _open(argv[1], "r")
            p = textformats.read_phase(fp, "0")
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-readPhaseChr":
            need(2)
            fp = _open(argv[1], "r")
            p = textformats.read_phase(fp, argv[2])
            _close(fp, argv[1])
            argv = argv[3:]
        elif cmd == "-write":
            need(1)
            fp = _open(argv[1], "wb")
            pbwtfile.write_pbwt(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeSites":
            need(1)
            fp = _open(argv[1], "w")
            pbwtfile.write_sites(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeSamples":
            need(1)
            fp = _open(argv[1], "w")
            pbwtfile.write_samples(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeMissing":
            need(1)
            fp = _open(argv[1], "wb")
            pbwtfile.write_missing(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeDosage":
            need(1)
            fp = _open(argv[1], "wb")
            pbwtfile.write_dosage(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeReverse":
            need(1)
            fp = _open(argv[1], "wb")
            pbwtfile.write_reverse(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeAll":
            need(1)
            pbwtfile.write_all(p, argv[1])
            argv = argv[2:]
        elif cmd == "-writeImputeRef":
            need(1)
            textformats.write_impute_ref(p, argv[1])
            argv = argv[2:]
        elif cmd == "-writeImputeHapsG":
            need(1)
            fp = _open(argv[1], "w")
            textformats.write_impute_haps_g(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writeGen":
            need(1)
            fp = _open(argv[1], "w")
            textformats.write_gen(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-writePhase":
            need(1)
            textformats.write_phase(p, argv[1])
            argv = argv[2:]
        elif cmd == "-writeTransposedHaplotypes":
            need(1)
            fp = _open(argv[1], "w")
            textformats.write_transposed_haplotypes(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-referenceFasta":
            need(1)
            reference_fasta = argv[1]
            argv = argv[2:]
        elif cmd in ("-writeVcf", "-writeVcfGz", "-writeBcf", "-writeBcfGz"):
            need(1)
            mode = {"-writeVcf": "w", "-writeVcfGz": "wz",
                    "-writeBcf": "wbu", "-writeBcfGz": "wb"}[cmd]
            vcf.write_vcf(p, argv[1], reference_fasta, mode)
            argv = argv[2:]
        elif cmd == "-checkpoint":
            need(1)
            registry.n_checkpoint = int(argv[1])
            argv = argv[2:]
        elif cmd == "-subsample":
            need(2)
            p = p.sub_sample_interval(int(argv[1]), int(argv[2]))
            argv = argv[3:]
        elif cmd == "-selectSamples":
            need(1)
            fp = _open(argv[1], "r")
            p = p.select_samples(pbwtfile.read_samples_file(fp))
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-subsites":
            need(2)
            p = p.sub_sites(float(argv[1]), float(argv[2]))
            argv = argv[3:]
        elif cmd == "-selectSites":
            need(1)
            fp = _open(argv[1], "r")
            sites, chrom = pbwtfile.read_sites_file(fp, None)
            _close(fp, argv[1])
            if chrom != p.chrom:
                raise SystemExit("chromosome mismatch in selectSites")
            p = p.select_sites(sites, keep_old=False)
            argv = argv[2:]
        elif cmd == "-removeSites":
            need(1)
            fp = _open(argv[1], "r")
            sites, chrom = pbwtfile.read_sites_file(fp, None)
            _close(fp, argv[1])
            if p.chrom and chrom != p.chrom:
                raise SystemExit("chromosome mismatch in removeSites")
            p = p.remove_sites(sites, keep_old=False)
            argv = argv[2:]
        elif cmd == "-subrange":
            need(2)
            p = p.sub_range(int(argv[1]), int(argv[2]))
            argv = argv[3:]
        elif cmd == "-corruptSites":
            need(2)
            from .algos import impute
            p = impute.corrupt_sites(p, float(argv[1]), float(argv[2]))
            argv = argv[3:]
        elif cmd == "-corruptSamples":
            need(2)
            from .algos import impute
            p = impute.corrupt_samples(p, float(argv[1]), float(argv[2]))
            argv = argv[3:]
        elif cmd == "-copySamples":
            need(2)
            from .algos import impute
            p = impute.copy_samples(p, int(argv[1]), float(argv[2]))
            argv = argv[3:]
        elif cmd == "-buildReverse":
            p.build_reverse()
            argv = argv[1:]
        elif cmd == "-pretty":
            need(2)
            from .algos import analyses
            fp = _open(argv[1], "w")
            analyses.pretty_plot(p, fp, int(argv[2]))
            _close(fp, argv[1])
            argv = argv[3:]
        elif cmd == "-siteInfo":
            need(3)
            from .algos import analyses
            fp = _open(argv[1], "w")
            analyses.export_site_info(p, fp, int(argv[2]), int(argv[3]))
            _close(fp, argv[1])
            argv = argv[4:]
        elif cmd == "-sfs":
            from .algos import analyses
            analyses.site_frequency_spectrum(p)
            argv = argv[1:]
        elif cmd == "-play":
            from .algos import analyses
            p = analyses.play_ground(p)
            argv = argv[1:]
        elif cmd == "-refFreq":
            need(1)
            fp = _open(argv[1], "r")
            pbwtfile.read_ref_freq(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-maxWithin":
            from .algos import match
            match.long_matches(p, 0)
            argv = argv[1:]
        elif cmd == "-longWithin":
            need(1)
            from .algos import match
            match.long_matches(p, int(argv[1]))
            argv = argv[2:]
        elif cmd == "-matchNaive":
            need(1)
            from .algos import match
            fp = _open(argv[1], "rb")
            q = pbwtfile.read_pbwt(fp)
            _close(fp, argv[1])
            match.match_sequences_naive(p, q)
            argv = argv[2:]
        elif cmd == "-matchIndexed":
            need(1)
            from .algos import match
            fp = _open(argv[1], "rb")
            q = pbwtfile.read_pbwt(fp)
            _close(fp, argv[1])
            match.match_sequences_indexed(p, q)
            argv = argv[2:]
        elif cmd == "-matchDynamic":
            need(1)
            from .algos import match
            fp = _open(argv[1], "rb")
            match.match_sequences_dynamic(p, fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-imputeExplore":
            need(1)
            from .algos import analyses
            analyses.impute_explore(p, int(argv[1]))
            argv = argv[2:]
        elif cmd == "-phase":
            need(1)
            from .algos import phase as phasemod
            p = phasemod.phase(p, int(argv[1]))
            argv = argv[2:]
        elif cmd == "-referencePhase":
            need(1)
            from .algos import phase as phasemod
            p = phasemod.reference_phase(p, argv[1])
            argv = argv[2:]
        elif cmd == "-referenceImpute":
            need(1)
            from .algos import impute
            root = argv[1]
            argv = argv[2:]
            n_sparse, f_sparse = 1, 1.0
            if argv and not argv[0].startswith("-"):
                n_sparse = int(argv[0])
                argv = argv[1:]
            if argv and not argv[0].startswith("-"):
                f_sparse = float(argv[0])
                argv = argv[1:]
            p = impute.reference_impute(p, root, n_sparse, f_sparse)
        elif cmd == "-genotypeCompare":
            need(1)
            from .algos import impute
            impute.genotype_compare(p, argv[1])
            argv = argv[2:]
        elif cmd == "-imputeMissing":
            from .algos import impute
            p = impute.impute_missing(p)
            argv = argv[1:]
        elif cmd == "-fitAlphaBeta":
            need(1)
            from .algos import likelihood
            likelihood.fit_alpha_beta(p, int(argv[1]))
            argv = argv[2:]
        elif cmd == "-llCopyModel":
            need(2)
            from .algos import likelihood
            likelihood.log_likelihood_copy_model(p, float(argv[1]), float(argv[2]))
            argv = argv[3:]
        elif cmd == "-readGeneticMap":
            need(1)
            from .algos import geneticmap
            fp = _open(argv[1], "r")
            geneticmap.read_genetic_map(fp)
            _close(fp, argv[1])
            argv = argv[2:]
        elif cmd == "-4hapsStats":
            from .algos import geneticmap
            geneticmap.pbwt_4haps_stats(p)
            argv = argv[1:]
        elif cmd in ("-paint", "-paintSparse"):
            need(1)
            from .algos import paint as paintmod
            root = argv[1]
            opts = []
            j = 2
            while j < len(argv) and j < 5 and not argv[j].startswith("-"):
                opts.append(argv[j])
                j += 1
            npr = int(opts[0]) if len(opts) > 0 else 100
            ploidy = int(opts[1]) if len(opts) > 1 else 2
            extra = float(opts[2]) if len(opts) > 2 else 0
            if cmd == "-paint":
                paintmod.paint_ancestry_matrix(p, root, npr, ploidy, int(extra))
            else:
                paintmod.paint_ancestry_matrix_sparse(p, root, npr, ploidy, extra)
            argv = argv[2 + len(opts):]
        else:
            raise SystemExit(f"unrecognised command {cmd}\n"
                             "Type pbwt without arguments for help")
        if profiling:
            import time as _time
            utils.log(f"wall\t{_time.perf_counter() - t_cmd:.3f} s\t{cmd}")
            t_cmd = _time.perf_counter()
        time_update()
    if profiling:
        import jax
        try:
            jax.profiler.stop_trace()
        except Exception as e:          # trace capture is best-effort
            sys.stderr.write(f"pbwt: profiler stop failed: {e}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
