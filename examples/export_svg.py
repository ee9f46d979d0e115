"""Tree visualization: SVG and ASCII export (reference: examples/svg/)."""
import sys

sys.path.insert(0, ".")

from libpll2_jax.trees import export_svg, parse_newick
from libpll2_jax.utils import show_tree_ascii

NEWICK = ("((t0:0.10,t1:0.22):0.05,(t2:0.30,(t3:0.12,t4:0.15):0.20):0.10,"
          "t5:0.40);")


def main(out="tree.svg"):
    tree = parse_newick(NEWICK)
    show_tree_ascii(tree.vroot)
    svg = export_svg(tree.vroot)
    with open(out, "w") as f:
        f.write(svg)
    print(f"wrote {out} ({len(svg)} bytes)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
