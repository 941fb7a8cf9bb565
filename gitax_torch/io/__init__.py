from .tsv import TSVFile, tsv_reader, tsv_writer, concat_tsv_files
from .image import load_image, image_from_base64
