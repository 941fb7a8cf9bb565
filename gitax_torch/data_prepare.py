"""A copy of `gitax.data_prepare` (`tests/test_torch_port_evalcap.py` holds
it equal to gitax's).

Data preparation CLI (reference data_prepare.py + taxonomy.py):
COCO Karpathy test -> base64 TSVs, and the ImageNet readable-names list
used by trie-constrained classification."""

from __future__ import annotations

import base64
import json
import logging
import os.path as op

from .common import (
    dispatch_main,
    hash_sha1,
    json_dump,
    load_list_file,
    read_to_buffer,
    write_to_file,
)
from .io.tsv import tsv_writer

# WordNet offsets whose bare synset names collide; disambiguated exactly
# like the reference (data_prepare.py:19-26)
NICK_NAME_OVERRIDES = {
    "n02012849": "crane bird",
    "n03126707": "crane machine",
    "n02113186": "cardigan dog",
    "n02963159": "cardigan jacket",
    "n03710637": "maillot tights",
    "n03710721": "maillot bathing suit",
}
SYNSET_LIST_SHA1 = "fb9737bbca048296520bc35582947b3755aa948f"
NICK_NAMES_SHA1 = "9c1dd12d7e8120820ffd44b75ebe8b78b659a4f4"


def noffset_to_synset(noffset):
    """WordNet offset string (e.g. n02084071) -> synset (reference
    taxonomy.py:9-11).  Requires the nltk wordnet corpus."""
    from nltk.corpus import wordnet as wn

    noffset = noffset.strip()
    return wn.synset_from_pos_and_offset(noffset[0], int(noffset[1:]))


def get_nick_name(synset):
    """Readable name: synset name minus the '.pos.nn' suffix, underscores
    to spaces (reference taxonomy.py:4-7)."""
    return synset.name()[:-5].replace("_", " ")


def get_imagenet_unique_nick_names(
    synset_mapping="./aux_data/imagenet/LOC_synset_mapping.txt",
):
    """(reference data_prepare.py:14-32)"""
    noffsets = [x.split(" ")[0] for x in load_list_file(synset_mapping)]
    assert hash_sha1(noffsets) == SYNSET_LIST_SHA1
    nick_names = [
        NICK_NAME_OVERRIDES.get(n) or get_nick_name(noffset_to_synset(n))
        for n in noffsets
    ]
    assert hash_sha1(nick_names) == NICK_NAMES_SHA1
    assert len(set(nick_names)) == len(nick_names)
    assert len(set(n.replace(" ", "") for n in nick_names)) == len(nick_names)
    return nick_names


def generate_imagenet_unique_names():
    nick_names = get_imagenet_unique_nick_names()
    write_to_file(
        "\n".join(nick_names),
        "./aux_data/imagenet/imagenet_unique_readable_names.txt",
    )


def prepare_coco_test(
    image_folder="aux_data/raw_data/val2014",
    json_file="aux_data/raw_data/dataset_coco.json",
    out_image_tsv="data/coco_caption/test.img.tsv",
    out_caption_tsv="data/coco_caption/test.caption.tsv",
):
    """Karpathy-split COCO test -> (key, base64 jpeg) + (key, captions
    json) TSVs (reference data_prepare.py:40-57)."""
    infos = json.loads(read_to_buffer(json_file))["images"]
    infos = [i for i in infos if i["split"] == "test"]
    assert all(i["filepath"] == "val2014" for i in infos)

    def gen_rows():
        for i in infos:
            payload = base64.b64encode(
                read_to_buffer(op.join(image_folder, i["filename"]))
            )
            yield i["cocoid"], payload

    tsv_writer(gen_rows(), out_image_tsv)

    def gen_cap_rows():
        for i in infos:
            caps = [{"caption": s["raw"]} for s in i["sentences"]]
            yield i["cocoid"], json_dump(caps)

    tsv_writer(gen_cap_rows(), out_caption_tsv)
    logging.info("wrote %d rows", len(infos))


if __name__ == "__main__":
    dispatch_main(globals())
